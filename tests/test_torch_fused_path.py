"""The fused-kernel configuration of the port against the JAX package, on
the CPU in float32.

The JAX package's two opt-in switches, ``LATENTSYNC_PALLAS_GN`` (GroupNorm
kernels K6/K7) and ``LATENTSYNC_FUSED_XATTN`` (the cross-attention block
kernel K5), configure the same served model in both packages; the VAE
mid-block's attention routes to a flash kernel in both. Here the port's
plain versions are held against the Pallas kernels in interpret mode
(atol/rtol 2e-5 for GroupNorm as in ``tests/test_groupnorm_kernel.py``,
2e-4 for the cross block, whose products sum in another order), the
port's routing predicates against the reference's, and the small UNet
with both switches set on both sides against the JAX model at
``tests/test_torch_models.py``'s tolerance.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_kernels.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.config import MotionModuleConfig as JMM
from latentsync_tpu.config import UNet3DConfig as JUNetCfg
from latentsync_tpu.models.unet3d import UNet3DConditionModel as JUNet
from latentsync_tpu.ops import attention as j_attn
from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu.ops import groupnorm as j_gn
from latentsync_tpu.utils.convert import convert_unet
from latentsync_tpu_torch.config import MotionModuleConfig, UNet3DConfig, VAEConfig
from latentsync_tpu_torch.models import unet3d as p_unet3d
from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
from latentsync_tpu_torch.models.vae import AutoencoderKL
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import groupnorm as p_gn
from latentsync_tpu_torch.utils.convert import init_random_

SWITCHES = ("LATENTSYNC_PALLAS_GN", "LATENTSYNC_FUSED_XATTN")
# tests/test_torch_models.py's small UNet and VAE, and its UNet tolerance
UNET_KW = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1, norm_num_groups=8,
               cross_attention_dim=16, attention_head_dim=4)
VAE_KW = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
UNET_ATOL, UNET_RTOL = 2e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gn_inputs(rng, shape):
    c = shape[1]
    x = (2 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


def _rows(x):
    """(N, C, *spatial) → the reference's channels-last (N·rows, C) and rows."""
    n, c = x.shape[:2]
    rows = math.prod(x.shape[2:])
    return np.moveaxis(x, 1, -1).reshape(n * rows, c), rows


@pytest.mark.parametrize("kernel", ["single", "streaming"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,eps", [
    ((2, 16, 4, 4, 4), 1e-5),   # cross-frame: (B, C, F, H, W), stats across frames
    ((6, 16, 4, 4), 1e-6),      # per-frame: the frame-folded (B·F, C, H, W)
])
def test_plain_group_norm_matches_pallas_kernels_interpret(kernel, silu, shape, eps):
    rng = np.random.default_rng(len(shape) + int(silu))
    x, scale, bias = _gn_inputs(rng, shape)
    x_rows, rows = _rows(x)
    if kernel == "single":
        ref = j_gn.group_norm_silu(jnp.asarray(x_rows), scale, bias, 4, rows, eps=eps,
                                   silu=silu, interpret=True)
    else:
        ref = j_gn.group_norm_silu_streaming(jnp.asarray(x_rows), scale, bias, 4, rows,
                                             eps=eps, silu=silu, block_rows=rows // 4,
                                             interpret=True)
    got = p_gn.group_norm_silu_reference(_t(x), _t(scale), _t(bias), 4, eps=eps, silu=silu)
    np.testing.assert_allclose(_rows(got.numpy())[0], np.asarray(ref), atol=2e-5, rtol=2e-5)


# (rows per sample, C) of every GroupNorm of the served UNet (32² latents,
# 16 frames; per-frame norms have H·W rows, cross-frame ones F·H·W), and
# one sample whose streaming blocks do not tile (plain in the reference)
_SERVED_GN = sorted({(16 * 32 * 32, c) for c in (320, 640, 960)}
                    | {(16 * 16 * 16, c) for c in (320, 640, 960, 1280, 1920)}
                    | {(16 * 8 * 8, c) for c in (640, 1280, 1920, 2560)}
                    | {(16 * 4 * 4, c) for c in (1280, 2560)}
                    | {(32 * 32, 320), (16 * 16, 640), (8 * 8, 1280), (4 * 4, 1280)})


@pytest.mark.parametrize("rows,c", _SERVED_GN + [(12345, 64)])
def test_group_norm_auto_routes_like_the_reference(monkeypatch, rows, c):
    """Spy on which of the reference's functions its router calls, and on
    which of the port's; no data is normalised (zero-stride inputs)."""
    calls = {}

    def spy(module, names):
        for name, tag in names:
            monkeypatch.setattr(module, name,
                                lambda *a, _tag=tag, **k: calls.setdefault(module, _tag))

    spy(j_gn, [("group_norm_silu", "single"), ("group_norm_silu_streaming", "streaming"),
               ("_reference", "plain")])
    spy(p_gn, [("group_norm_silu", "single"), ("group_norm_silu_streaming", "streaming"),
               ("group_norm_silu_reference", "plain")])
    j_gn.group_norm_silu_auto(np.broadcast_to(np.float32(0), (rows, c)), None, None, 32, rows)
    p_gn.group_norm_silu_auto(torch.zeros(1).expand(1, c, rows), None, None, 32)
    assert calls[p_gn] == calls[j_gn] == (p_gn.gn_route(rows, c) or "plain")
    if rows * c * 4 > 2 * 2**20 and rows != 12345:
        assert calls[p_gn] == "streaming"   # e.g. (4, 2560, 16, 4, 4): over 2 MiB


def _cross_inputs(rng, b, s, sk, c, cc):
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    ctx = rng.standard_normal((b, sk, cc)).astype(np.float32)
    wq = (rng.standard_normal((c, c)) / math.sqrt(c)).astype(np.float32)
    wk, wv = ((rng.standard_normal((cc, c)) / math.sqrt(cc)).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((c, c)) / math.sqrt(c)).astype(np.float32)
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ls = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, ctx, ls, lb, wq, wk, wv, wo, bo


def test_plain_cross_block_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(21)
    b, s, sk, c, cc, heads = 2, 32, 10, 32, 24, 4
    x, ctx, ls, lb, wq, wk, wv, wo, bo = _cross_inputs(rng, b, s, sk, c, cc)
    ref = j_ab._cross_fused(jnp.asarray(x), jnp.asarray(ctx), ls, lb, wq, wk, wv, wo, bo, heads,
                            1e-6, 1.0 / math.sqrt(c // heads), 1, True)
    got = p_ab.cross_attention_block_reference(_t(x), _t(ls), _t(lb), _t(ctx), _t(wq.T),
                                               _t(wk.T), _t(wv.T), _t(wo.T), _t(bo), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


# (B·F, S, C) of every audio cross-attention block of the served UNet
# (batch 4 × 16 frames, Sk = 50 whisper tokens of 384), and shapes just
# outside the reference's limits
@pytest.mark.parametrize("b,s,sk,c,cc", [
    (64, 1024, 50, 320, 384), (64, 256, 50, 640, 384), (64, 64, 50, 1280, 384),
    (64, 16, 50, 1280, 384), (32, 1024, 50, 320, 384), (3, 8, 50, 320, 384),
    (2, 2048, 50, 320, 384), (4, 64, 4, 320, 384), (4, 64, 8, 320, 384),
    (1, 1024, 1500, 320, 384),
])
def test_cross_fused_route_matches_the_reference(b, s, sk, c, cc):
    heads = 8
    ref = j_ab._pick_cross_block(b, s, sk, c, cc, c, heads) > 0 and 16 <= s <= 1024 and sk >= 8
    assert p_ab.cross_fused_route(b, s, sk, c, cc, c) == ref


def test_plain_attention_matches_jax_at_a_flash_shape():
    rng = np.random.default_rng(22)
    q, k, v = (rng.standard_normal((2, 256, 1, 64)).astype(np.float32) for _ in range(3))
    ref = j_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = p_attn.dot_product_attention_reference(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    # on a CPU tensor the routed op is the plain version
    np.testing.assert_array_equal(p_attn.dot_product_attention(_t(q), _t(k), _t(v)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("q_shape,k_shape", [
    ((64, 1024, 1, 512), (64, 1024, 1, 512)),   # VAE mid-block, encode
    ((32, 1024, 1, 512), (32, 1024, 1, 512)),   # VAE mid-block, decode
    ((2, 256, 1, 64), (2, 256, 1, 64)), ((2, 384, 2, 64), (2, 384, 2, 64)),
    ((2, 320, 1, 64), (2, 320, 1, 64)), ((2, 128, 1, 64), (2, 128, 1, 64)),
    ((1, 1500, 6, 64), (1, 1500, 6, 64)),       # whisper
    ((64, 1024, 8, 40), (64, 50, 8, 40)),       # audio cross-attention
    ((2, 3, 256, 4, 8), (2, 3, 256, 4, 8)),     # not 4-D
])
def test_flash_route_matches_the_reference(q_shape, k_shape):
    ref = (len(q_shape) == 4 and q_shape[1] >= 256 and q_shape[1] == k_shape[1]
           and j_attn._pick_block(q_shape[1]) is not None)
    q, k = torch.empty(q_shape, device="meta"), torch.empty(k_shape, device="meta")
    assert p_attn.flash_route(q, k) == ref


@pytest.fixture(scope="module")
def unet_pair():
    port = init_random_(UNet3DConditionModel(
        UNet3DConfig(**UNET_KW, motion_module=MotionModuleConfig(num_attention_heads=4))),
        seed=3)
    params = convert_unet({k: v.numpy() for k, v in port.state_dict().items()},
                          in_channels=13, out_channels=4, cross_attention_dim=16)
    return port, JUNet(JUNetCfg(**UNET_KW, motion_module=JMM(num_attention_heads=4))), params


def test_unet_fused_configuration_matches_jax(unet_pair, monkeypatch):
    """Both switches on both sides: the JAX model runs its own plain
    fallbacks on the CPU, the port its plain versions; the port's norms go
    through the GroupNorm router, the VAE's do not."""
    port, jax_model, params = unet_pair
    for k in SWITCHES:
        monkeypatch.setenv(k, "1")
    routed = []
    auto = p_unet3d.group_norm_silu_auto
    monkeypatch.setattr(p_unet3d, "group_norm_silu_auto",
                        lambda x, *a: routed.append(tuple(x.shape)) or auto(x, *a))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 16, 8, 8)).astype(np.float32)
    audio = rng.standard_normal((2, 16, 5, 16)).astype(np.float32)
    t = np.array([17, 503])
    with torch.no_grad():
        eps = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(audio)).numpy()
    ref = jax_model.apply(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(t),
                          jnp.asarray(audio))
    np.testing.assert_allclose(eps, np.asarray(ref).transpose(0, 4, 1, 2, 3),
                               atol=UNET_ATOL, rtol=UNET_RTOL)
    # every GroupNorm of the UNet (resnets, transformers, motion modules,
    # conv_norm_out) runs once a forward, through the router
    assert len(routed) == sum(isinstance(m, torch.nn.GroupNorm) for m in port.modules())
    assert (2, 32, 16, 8, 8) in routed and (32, 32, 8, 8) in routed


def test_unet_parameter_tree_is_the_same_with_the_gn_switch(unet_pair, monkeypatch):
    _, jax_model, _ = unet_pair
    args = (jnp.zeros((1, 16, 8, 8, 13)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 5, 16)))

    def keys():
        tree = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), *args)
        return sorted((jax.tree_util.keystr(p), v.shape)
                      for p, v in jax.tree_util.tree_leaves_with_path(tree))

    monkeypatch.delenv("LATENTSYNC_PALLAS_GN", raising=False)
    plain = keys()
    monkeypatch.setenv("LATENTSYNC_PALLAS_GN", "1")
    assert keys() == plain


def test_vae_norms_ignore_the_gn_switch(monkeypatch):
    vae = init_random_(AutoencoderKL(VAEConfig(**VAE_KW)), seed=5)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 4, 4, 4)).astype(np.float32))
    with torch.no_grad():
        want = vae.moments(x)[0], vae.decode(z)
        monkeypatch.setenv("LATENTSYNC_PALLAS_GN", "1")

        def refuse(*a, **k):
            raise AssertionError("a VAE norm went through the GroupNorm kernels' router")

        monkeypatch.setattr(p_unet3d, "group_norm_silu_auto", refuse)
        monkeypatch.setattr(p_gn, "group_norm_silu_auto", refuse)
        got = vae.moments(x)[0], vae.decode(z)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
