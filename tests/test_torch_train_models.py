"""The stage-2 trainer's frozen nets and helpers against the JAX package.

StableSyncNet (``test_parity_syncnet.py``'s tiny config: an attention
block, a width change, a (1, 2) factor, towers ending at 1×1), LPIPS (full
VGG16 widths at 32×48, so the five taps keep a pixel) and TREPA (a tiny
VideoViT, frames downsampled and tiled) run on the same weights in both
packages, carried over by the port's converter inverses; forward values
and the gradients with respect to the inputs are compared. The converter
inverses round-trip, and the Wav2Lip mel, DDIM's ``add_noise`` /
``pred_x0`` and the cosine-BCE match. f32; tolerances at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu import config as jc
from latentsync_tpu.models import perceptual as jp
from latentsync_tpu.models import syncnet as js
from latentsync_tpu.models import videomae as jv
from latentsync_tpu.ops.ddim import DDIMScheduler as JDDIM
from latentsync_tpu.ops.mel import wav2lip_melspectrogram_np as j_mel
from latentsync_tpu.training.losses import cosine_bce_loss as j_cos
from latentsync_tpu.utils.convert import convert_stable_syncnet
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.perceptual import LPIPS
from latentsync_tpu_torch.models.syncnet import StableSyncNet
from latentsync_tpu_torch.models.videomae import TREPALoss, VideoViT, VideoViTConfig
from latentsync_tpu_torch.ops.ddim import DDIMScheduler as PDDIM
from latentsync_tpu_torch.ops.mel import wav2lip_melspectrogram_np as p_mel
from latentsync_tpu_torch.training.losses import cosine_bce_loss as p_cos
from latentsync_tpu_torch.utils import convert as pc

AUD = dict(in_channels=1, block_out_channels=(32, 64, 64), downsample_factors=(2, 2, 4),
           attn_blocks=(0, 1, 0))
VIS = dict(in_channels=6, block_out_channels=(32, 64, 64),
           downsample_factors=((1, 2), 4, 4), attn_blocks=(0, 1, 0))
VIT = dict(img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_frames=4,
           mlp_ratio=4.0)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _syncnet(last_width: int = 64):
    aud = dict(AUD, block_out_channels=AUD["block_out_channels"][:-1] + (last_width,))
    vis = dict(VIS, block_out_channels=VIS["block_out_channels"][:-1] + (last_width,))
    cfg = pcfg.SyncNetConfig(pcfg.SyncNetEncoderConfig(**aud), pcfg.SyncNetEncoderConfig(**vis))
    port = pc.init_random_(StableSyncNet(cfg), seed=7)
    jcfg = jc.SyncNetConfig(jc.SyncNetEncoderConfig(**aud), jc.SyncNetEncoderConfig(**vis))
    return port, js.StableSyncNet(jcfg), convert_stable_syncnet(_np_sd(port))


def _lpips():
    port = pc.init_random_(LPIPS(), seed=8)
    sd = _np_sd(port)
    vgg = {k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")}
    params = {"params": {"vgg": jp.convert_vgg16_torchvision(vgg), **jp.convert_lpips(sd)}}
    return port, params


def _vit():
    port = pc.init_random_(VideoViT(VideoViTConfig(**VIT)), seed=9)
    return port, jv.convert_videomae(_np_sd(port))


@pytest.mark.parametrize("last_width", [64, 256])
def test_stable_syncnet_forward_and_input_gradients_match_jax(last_width):
    """At ``test_parity_syncnet.py``'s widths (last 64) the forward; the
    gradient there is ill-conditioned in f32 in both packages: the last
    GroupNorm normalises groups of 2 values on a 1×1 map (the JAX
    package's f32 gradient is 8 % (frames) and 21 % (mel) off an f64
    evaluation of the same function, the port's 0.7 % and 0.3 %). With the
    last width 256 (groups of 8; the release's are 64 wide) both are within
    2e-6 of it, and the gradients are held to 1e-5 there."""
    port, jmodel, params = _syncnet(last_width)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 16, 32, 6)).astype(np.float32)
    mels = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    cv, ca = (rng.standard_normal((2, last_width)).astype(np.float32) for _ in range(2))

    @jax.jit
    def jfn(f, m, cot):
        out, vjp = jax.vjp(lambda f, m: jmodel.apply(params, f, m), f, m)
        return out, vjp(cot)

    (jv_, ja), (gf, gm) = jfn(jnp.asarray(frames), jnp.asarray(mels),
                              (jnp.asarray(cv), jnp.asarray(ca)))
    tf = torch.from_numpy(frames.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    tm = torch.from_numpy(mels.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    pv, pa = port(tf, tm)
    # unit embeddings of the same weights: f32 sums in other orders
    np.testing.assert_allclose(pv.detach().numpy(), jv_, atol=2e-5)
    np.testing.assert_allclose(pa.detach().numpy(), ja, atol=1e-4)
    if last_width == 64:
        return
    torch.autograd.backward((pv, pa), (torch.from_numpy(cv), torch.from_numpy(ca)))
    assert _rel(tf.grad.numpy().transpose(0, 2, 3, 1), gf) < 1e-5
    assert _rel(tm.grad.numpy().transpose(0, 2, 3, 1), gm) < 1e-5


def test_lpips_forward_and_input_gradients_match_jax():
    port, params = _lpips()
    rng = np.random.default_rng(1)
    x, y = (rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(2))

    @jax.jit
    def jfn(a, b):
        out, vjp = jax.vjp(lambda a, b: jp.LPIPS().apply(params, a, b), a, b)
        return out, vjp(jnp.ones(2, jnp.float32))

    ref, (gx, gy) = jfn(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
              for a in (x, y))
    out = port(tx, ty)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4, atol=1e-7)
    out.sum().backward()
    assert _rel(tx.grad.numpy().transpose(0, 2, 3, 1), gx) < 1e-4
    assert _rel(ty.grad.numpy().transpose(0, 2, 3, 1), gy) < 1e-4


def test_trepa_loss_and_input_gradients_match_jax():
    port, params = _vit()
    jloss = jv.TREPALoss(params=params, config=jv.VideoViTConfig(**VIT))
    rng = np.random.default_rng(2)
    # 2 frames of 24²: downsampled to 16² (antialiased) and tiled to 4
    a, b = (rng.uniform(-1, 1, (1, 2, 24, 24, 3)).astype(np.float32) for _ in range(2))
    ref, grads = jax.jit(jax.value_and_grad(lambda u, w: jloss(u, w), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(v.transpose(0, 1, 4, 2, 3).copy()).requires_grad_(True)
              for v in (a, b))
    out = TREPALoss(port)(ta, tb)
    assert abs(float(out.detach()) - float(ref)) <= 1e-5 * abs(float(ref)) + 1e-9
    out.backward()
    assert _rel(ta.grad.numpy().transpose(0, 1, 3, 4, 2), grads[0]) < 1e-4
    assert _rel(tb.grad.numpy().transpose(0, 1, 3, 4, 2), grads[1]) < 1e-4


@pytest.mark.parametrize("src,dst", [(256, 64), (32, 16), (16, 24), (48, 20)])
def test_trepa_resize_is_jax_bilinear(src, dst):
    """``F.interpolate(bilinear, antialias=True, align_corners=False)`` is
    ``jax.image.resize(..., "bilinear")`` (antialiased when downsampling)."""
    im = np.random.default_rng(src).uniform(-1, 1, (2, src, src, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(im), (2, dst, dst, 3), "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(im.transpose(0, 3, 1, 2)), size=(dst, dst), mode="bilinear",
        align_corners=False, antialias=True).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_converter_inverses_round_trip():
    """upstream state dict → the JAX package's converter → the port's inverse
    gives back every tensor exactly, for StableSyncNet, LPIPS and VideoMAE."""
    from latentsync_tpu.models.perceptual import convert_lpips, convert_vgg16_torchvision

    port, _, params = _syncnet()
    cases = [(_np_sd(port), pc.stable_syncnet_state_dict_from_flax(params))]
    lp, lparams = _lpips()
    cases.append((_np_sd(lp), pc.lpips_state_dict_from_flax(lparams)))
    vit, vparams = _vit()
    cases.append((_np_sd(vit), pc.videomae_state_dict_from_flax(vparams)))
    for sd, back in cases:
        assert set(back) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    assert set(convert_lpips(_np_sd(lp))) == {f"lin_{i}" for i in range(5)}
    assert len(convert_vgg16_torchvision(
        {k[4:]: v for k, v in _np_sd(lp).items() if k.startswith("vgg.")})) == 13


def test_videomae_inverse_refuses_a_k_bias():
    _, params = _vit()
    bias = params["params"]["blocks_0"]["qkv"]["bias"]
    bias[bias.shape[0] // 3] = 1.0
    with pytest.raises(ValueError, match="k bias"):
        pc.videomae_state_dict_from_flax(params)


@pytest.mark.parametrize("seconds", [0.5, 1.37])
def test_wav2lip_mel_matches_jax(seconds):
    audio = (0.3 * np.random.default_rng(3).standard_normal(int(16000 * seconds))).astype(
        np.float32)
    ref, got = j_mel(audio), p_mel(audio)
    assert got.shape == ref.shape
    # dB of f32 spectra through two FFT implementations, clipped to [-4, 4]
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_ddim_training_helpers_and_cosine_bce_match_jax():
    rng = np.random.default_rng(4)
    x0, noise, eps = (rng.standard_normal((3, 4, 2, 5, 5)).astype(np.float32) for _ in range(3))
    t = np.array([0, 517, 999], np.int32)
    js_, ps = JDDIM.create(jc.SchedulerConfig()), PDDIM.create(pcfg.SchedulerConfig())
    tt = torch.from_numpy(t)
    np.testing.assert_allclose(
        ps.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), tt).numpy(),
        js_.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)), atol=1e-6)
    np.testing.assert_allclose(
        ps.pred_x0(torch.from_numpy(eps), torch.from_numpy(x0), tt).numpy(),
        js_.pred_x0(jnp.asarray(eps), jnp.asarray(x0), jnp.asarray(t)), rtol=1e-5, atol=1e-5)
    v, a = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    a[0] = v[0]  # a similarity of 1: the clip
    y = np.array([1, 0, 1, 0], np.float32)
    np.testing.assert_allclose(p_cos(torch.from_numpy(v), torch.from_numpy(a),
                                     torch.from_numpy(y)).numpy(),
                               j_cos(jnp.asarray(v), jnp.asarray(a), jnp.asarray(y)), rtol=1e-5)
