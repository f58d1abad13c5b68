"""The port's stage-2 trainer against the JAX package's, on one set of weights.

``tests/test_training.py``'s tiny UNet (32/64/64/64, one layer a level,
4 frames) with pixel-space supervision, the frozen SyncNet, LPIPS and TREPA
on, at 32² faces (16² latents, so the VAE mid-block and the first level's
spatial attention take the flash route's shape, S = 256; the lower half
keeps a pixel at LPIPS's last tap). Every weight is drawn non-zero in the
port (``init_random_``: zeroed conv_out would make every trainable
gradient 0) and carried into the JAX models by the JAX package's
converters. JAX's own ``t`` and mixed noise (from its PRNG key) are given to
the port. Held against ``jax.value_and_grad`` of the JAX ``loss_fn``: each
loss component, the gradient of every trainable tensor, the global norm
the clip uses (over *all* parameters, frozen ones included), the clipped
gradients, and one step's updated parameters against optax's (AdamW with
optax's weight decay, at a learning rate where the decay shows). The
data, masks, checkpoints and the CLI: ``tests/test_torch_train_data.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from latentsync_tpu import config as jc
from latentsync_tpu.models import perceptual as jp
from latentsync_tpu.models import videomae as jv
from latentsync_tpu.training.losses import mixed_noise as j_mixed_noise
from latentsync_tpu.training.unet_trainer import UNetTrainer as JTrainer
from latentsync_tpu.training.unet_trainer import trainable_mask as j_mask
from latentsync_tpu.utils.convert import convert_stable_syncnet, convert_unet, convert_vae
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.models.perceptual import LPIPS
from latentsync_tpu_torch.models.syncnet import StableSyncNet
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.models.videomae import TREPALoss, VideoViT, VideoViTConfig
from latentsync_tpu_torch.training.unet_trainer import UNetTrainer, clip_grad_norm_all
from latentsync_tpu_torch.utils import convert as pc

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


LR = 1e-2  # AdamW's decay (1e-4 against torch's default 1e-2) moves lr·wd·p
VIT = dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=2, num_frames=4,
           mlp_ratio=4.0)


def _cfg(m, lr=LR):
    """The tiny stage-2 config in package `m` (``jc`` or ``pcfg``). SyncNet's
    towers end at 1×1 with 256 channels: groups of 8 in the last GroupNorm
    (with 2, the f32 gradient through it is ill-conditioned in both
    packages, ``test_torch_train_models.py``)."""
    enc = m.SyncNetEncoderConfig
    return m.LatentSyncConfig(
        unet=m.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                            motion_module=m.MotionModuleConfig(num_attention_heads=4,
                                                               num_transformer_block=1)),
        vae=m.VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
        syncnet=m.SyncNetConfig(
            audio_encoder=enc(1, (32, 64, 256), ((4, 2), (4, 2), (5, 4)), (0, 1, 0)),
            visual_encoder=enc(12, (32, 64, 256), ((1, 2), 4, 4), (0, 1, 0))),
        run=m.RunConfig(lr=lr),
        data=m.DataConfig(num_frames=4, resolution=32))


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    return {"gt_pixels": u(1, 4, 32, 32, 3), "masked_pixels": u(1, 4, 32, 32, 3),
            "ref_pixels": u(1, 4, 32, 32, 3),
            # full resolution: both trainers resize it to the latents'
            "masks": (rng.uniform(size=(1, 4, 32, 32, 1)) > 0.4).astype(np.float32),
            "audio_embeds": u(1, 4, 10, 16), "mel": u(1, 80, 13, 1) * 4}


@pytest.fixture(scope="module")
def pair():
    """(port trainer, JAX loss value and metrics, JAX grads, JAX params, JAX
    tx and opt_state, batch, t, noise), computed once."""
    cfg, jcfg = _cfg(pcfg), _cfg(jc)
    unet = pc.init_random_(UNet3DConditionModel(cfg.unet), seed=11)
    vae = pc.init_random_(AutoencoderKL(cfg.vae), seed=12)
    syncnet = pc.init_random_(StableSyncNet(cfg.syncnet), seed=13)
    lpips = pc.init_random_(LPIPS(), seed=14)
    vit = pc.init_random_(VideoViT(VideoViTConfig(**VIT)), seed=15)
    params = jax.tree.map(jnp.asarray, convert_unet(_np(unet.state_dict()), 13, 4, 16))
    lsd = _np(lpips.state_dict())
    lparams = {"params": {"vgg": jp.convert_vgg16_torchvision(
        {k[4:]: v for k, v in lsd.items() if k.startswith("vgg.")}), **jp.convert_lpips(lsd)}}
    jl = jp.LPIPS()

    def perceptual_fn(x, y):
        fl = lambda v: v.reshape((-1,) + v.shape[2:])  # noqa: E731
        return jnp.mean(jl.apply(lparams, fl(x), fl(y)))

    trepa_fn = jv.TREPALoss(params=jv.convert_videomae(_np(vit.state_dict())),
                            config=jv.VideoViTConfig(**VIT))
    jt = JTrainer(jcfg, dtype=jnp.float32)
    loss_fn, _ = jt.make_train_step(
        vae_params=convert_vae(_np(vae.state_dict())),
        syncnet_params=convert_stable_syncnet(_np(syncnet.state_dict())),
        perceptual_fn=perceptual_fn, trepa_fn=trepa_fn)
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    # the draws loss_fn makes from rng (unet_trainer.py:122-127)
    rng_t, rng_n = jax.random.split(rng)
    t = np.asarray(jax.random.randint(rng_t, (1,), 0, 1000))
    noise = np.asarray(j_mixed_noise(rng_n, (1, 4, 16, 16, 4), 1.0))
    tx = jt.make_optimizer(params)
    trainer = UNetTrainer(cfg, unet, vae, syncnet, lpips, TREPALoss(vit), dtype=torch.float32)
    return dict(trainer=trainer, metrics=metrics, grads=grads, params=params, tx=tx,
                batch=batch, t=torch.from_numpy(t.copy()).long(),
                noise=torch.from_numpy(noise.transpose(0, 4, 1, 2, 3).copy()))


def test_loss_components_and_trainable_gradients_match_jax(pair):
    tr = pair["trainer"]
    losses, grads = tr.gradients(pair["batch"], pair["t"], pair["noise"])
    m = pair["metrics"]
    assert set(losses) == set(m) == {"recon", "perceptual", "trepa", "sync", "total"}
    # the sync loss is not at its clip (a similarity in (eps, 1 - eps) passes gradient)
    assert float(losses["sync"].detach()) < 16.0
    for k in m:
        # f32 through the UNet, the VAE decode and the loss nets, summed in
        # other orders by the two frameworks
        assert abs(float(losses[k].detach()) - float(m[k])) <= 1e-4 * abs(float(m[k])) + 1e-6, k
    ref = pc.unet_state_dict_from_flax(jax.tree.map(np.asarray, pair["grads"]))
    assert set(ref) == set(grads)
    trainable = [n for n in grads if tr.mask[n]]
    assert trainable and len(trainable) < len(grads)
    for n in trainable:
        assert torch.isfinite(grads[n]).all() and grads[n].abs().max() > 0, n
        # per-tensor relative L2 of f32 gradients (the largest seen: ~1e-4)
        assert _rel(grads[n].numpy(), ref[n].numpy()) < 2e-3, n


def test_one_step_matches_optax_clip_and_adamw(pair):
    """The clip uses the norm of every gradient, frozen ones too, as optax's
    ``clip_by_global_norm`` ahead of the mask does; AdamW is optax's (weight
    decay 1e-4); frozen parameters stay bit for bit and hold no state. The
    JAX trainer's own ``make_optimizer`` chain runs on the gradients packed
    into two leaves, a trainable one (its path holds ``motion_modules``)
    and a frozen one: every transform of the chain is elementwise or
    global, so that is the chain on the whole tree."""
    tr = pair["trainer"]
    before = {n: p.detach().clone() for n, p in tr.params.items()}
    ref = pc.unet_state_dict_from_flax(jax.tree.map(np.asarray, pair["grads"]))
    names = {True: [n for n in before if tr.mask[n]], False: [n for n in before
                                                           if not tr.mask[n]]}

    def pack(d):
        return {"motion_modules": jnp.concatenate([jnp.ravel(d[n]) for n in names[True]]),
                "resnets": jnp.concatenate([jnp.ravel(d[n]) for n in names[False]])}

    g2 = pack({n: v.numpy() for n, v in ref.items()})
    p2 = pack({n: v.numpy() for n, v in before.items()})
    jt = JTrainer(_cfg(jc), dtype=jnp.float32)
    tx = jt.make_optimizer(p2)
    assert jax.tree.map(bool, j_mask(p2, tr.config.run.trainable_modules)) == {
        "motion_modules": True, "resnets": False}
    max_norm = tr.config.run.max_grad_norm
    norm_all = float(optax.global_norm(g2))
    # the clip is active, and a trainable-only norm would scale otherwise
    assert norm_all > max_norm
    assert norm_all > 1.01 * float(optax.global_norm(g2["motion_modules"]))
    clipped = optax.clip_by_global_norm(max_norm).update(g2, None)[0]["motion_modules"]
    updates, _ = tx.update(g2, tx.init(p2), p2)
    stepped = np.asarray(optax.apply_updates(p2, updates)["motion_modules"])

    _, grads = tr.gradients(pair["batch"], pair["t"], pair["noise"])
    grads = {n: g.clone() for n, g in grads.items()}
    clip_grad_norm_all(list(grads.values()), max_norm)
    got = np.concatenate([grads[n].numpy().ravel() for n in names[True]])
    assert _rel(got, clipped) < 2e-3

    metrics = tr.train_step(pair["batch"], pair["t"], pair["noise"])
    assert abs(metrics["grad_norm"] - norm_all) <= 1e-4 * norm_all
    # Adam's first step is lr · g / (|g| + 1e-8) plus lr · 1e-4 · p: ±lr
    # wherever the gradient's sign is decided, and there the two agree to
    # float rounding; an element whose gradient is within the frameworks'
    # f32 difference of 0 may step either way
    g = np.asarray(clipped)
    sure = np.abs(g) > 1e-6
    assert sure.mean() > 0.95
    step = np.concatenate([(tr.params[n].detach() - before[n]).numpy().ravel()
                           for n in names[True]])
    ref_step = stepped - np.asarray(p2["motion_modules"])
    np.testing.assert_allclose(step[sure], ref_step[sure], atol=1e-7, rtol=1e-4)
    for n in names[False]:
        assert torch.equal(tr.params[n].detach(), before[n]), n
    state = tr.optimizer.state
    assert len(state) == len(names[True])
    assert all(tr.params[n] in state for n in names[True])
