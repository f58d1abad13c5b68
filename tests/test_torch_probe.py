"""The kernel-probe slice of the port against the JAX package, on the CPU.

The four kernel-bearing functions the probe adds (``qkv_proj``,
``geglu_ffn_int8io`` with ``quantize_rowwise``, ``oneshot_attention``,
``flash_attention``) run their plain versions here (CPU tensors) and are
held against the JAX functions they replace on the same numpy-seeded
inputs, the Pallas kernels in interpret mode. Then the slice as a whole:
every ported mode of ``latentsync_tpu_torch.scripts.micro_probe`` runs at
toy shapes and prints finite JSON lines. Each tolerance is stated where it
is used; the kernels themselves are held to these plain versions on the
card by ``tests/test_torch_kernels.py``.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from latentsync_tpu.ops import attention as j_attn
from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu_torch import config as pcfg
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.scripts import micro_probe as mp
from latentsync_tpu_torch.utils.convert import linear_weight


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead,c,inner", [((4, 64), 64, 64), ((256,), 64, 128)])
def test_qkv_proj_matches_the_pallas_kernel(lead, c, inner):
    """f32 on both sides, different summation orders: atol = rtol = 2e-5
    (the bound of the JAX package's own test of this kernel)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, c)).astype(np.float32)
    ws = [(rng.standard_normal((c, inner)) * 0.05).astype(np.float32) for _ in range(3)]
    ref = j_ffn.qkv_proj(jnp.asarray(x), *map(jnp.asarray, ws), interpret=True)
    got = p_ffn.qkv_proj(_t(x), *[linear_weight(w) for w in ws])
    for g, r in zip(got, ref):
        assert g.shape == (*lead, inner)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------


def test_quantize_rowwise_matches_jax():
    """Codes equal; scales to rtol 1e-6 (one f32 division and one addition)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 48)).astype(np.float32) * 3
    x[5] = 0  # an all-zero row: scale 1e-12, zero codes
    ji, js = j_ffn.quantize_rowwise(jnp.asarray(x))
    pi, ps = p_ffn.quantize_rowwise(_t(x))
    assert pi.dtype == torch.int8 and ps.shape == (64, 1)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ps[5]) == pytest.approx(1e-12) and not pi[5].any()


def _i8_inputs(m=256, c=128):
    rng = np.random.default_rng(5)
    inner = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w_up = (rng.standard_normal((c, 2 * inner)) * 0.05).astype(np.float32)
    b_up = (rng.standard_normal(2 * inner) * 0.05).astype(np.float32)
    w_dn = (rng.standard_normal((inner, c)) * 0.05).astype(np.float32)
    b_dn = (rng.standard_normal(c) * 0.05).astype(np.float32)
    return x, w_up, b_up, w_dn, b_dn


def test_geglu_ffn_int8io_matches_the_pallas_kernel():
    """The Pallas kernel (interpret mode, bm = bi = 128) uses an
    approximate erf and sums its inner blocks in another order, so an
    output may cross a rounding boundary: scales to rtol 1e-3, codes within
    1, and the dequantized output within the JAX package's own bound for
    this kernel, rowmax/127 + 0.02, of the float composition."""
    x, w_up, b_up, w_dn, b_dn = _i8_inputs()
    inner = w_dn.shape[0]
    ji, js = j_ffn.quantize_rowwise(jnp.asarray(x))
    oi, os_ = j_ffn.geglu_ffn_int8io(ji, js, *map(jnp.asarray, (w_up, b_up, w_dn, b_dn)),
                                     bm=128, bi=128, interpret=True)
    pi, ps = p_ffn.quantize_rowwise(_t(x))
    gi, gs = p_ffn.geglu_ffn_int8io(pi, ps, linear_weight(w_up), _t(b_up), linear_weight(w_dn),
                                    _t(b_dn))
    assert gi.dtype == torch.int8 and gi.shape == x.shape and gs.shape == (x.shape[0], 1)
    np.testing.assert_allclose(gs.numpy(), np.asarray(os_), rtol=1e-3, atol=0)
    assert np.abs(gi.numpy().astype(np.int32) - np.asarray(oi, np.int32)).max() <= 1
    xd = np.asarray(ji, np.float32) * np.asarray(js)
    want = np.asarray(j_ffn._geglu_xla(jnp.asarray(xd), w_up[:, :inner], w_up[:, inner:],
                                       b_up[:inner], b_up[inner:], w_dn, b_dn))
    tol = np.abs(want).max(axis=-1, keepdims=True) / 127.0 + 0.02
    assert np.all(np.abs(gi.numpy().astype(np.float32) * gs.numpy() - want) <= tol)


def test_geglu_ffn_int8io_output_feeds_the_next_call():
    """The probe chains K10 on its own output; an all-zero row with zero
    biases stays all-zero with scale 1e-12."""
    x, w_up, b_up, w_dn, b_dn = _i8_inputs(64, 32)
    x[3] = 0
    args = (linear_weight(w_up), torch.zeros(w_up.shape[1]), linear_weight(w_dn),
            torch.zeros(w_dn.shape[1]))
    carry = p_ffn.quantize_rowwise(_t(x))
    for _ in range(3):
        carry = p_ffn.geglu_ffn_int8io(*carry, *args)
        assert carry[0].dtype == torch.int8 and bool(torch.isfinite(carry[1]).all())
        assert not carry[0][3].any() and float(carry[1][3]) == pytest.approx(1e-12)
    assert p_ffn.geglu_ffn_int8io.launches == 0  # CPU tensors launch nothing


# ---------------------------------------------------------------------------
# K11, K12 and the flash route
# ---------------------------------------------------------------------------


def _qkv(seed, *shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,d", [(4, 64, 40), (2, 128, 16)])
def test_oneshot_attention_matches_the_pallas_kernel(b, s, d):
    """f32 on both sides (rounding p to f32 is no rounding): atol 2e-5."""
    q, k, v = _qkv(6, b, s, d)
    ref = j_attn.oneshot_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = p_attn.oneshot_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_flash_attention_matches_the_composed_lowering():
    """D = 40 is no multiple of 128: the JAX entry runs its composed
    lowering, and so does the port on a CPU tensor. f32: atol 2e-5."""
    q, k, v = _qkv(7, 3, 256, 40)
    ref = j_attn.flash_attention(*map(jnp.asarray, (q, k, v)))
    got = p_attn.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 512)])
def test_flash_attention_matches_the_pallas_kernel_body(sq, sk):
    """The JAX entry reaches ``pl.pallas_call`` without an interpret switch,
    so the kernel body ``_flash_kernel`` runs here through the same
    BlockSpecs with ``interpret=True``. Streaming against whole-row
    softmax in f32: atol 2e-5."""
    b, d, bq, bk = 2, 128, 256, 256
    rng = np.random.default_rng(8)
    q = rng.standard_normal((b, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, d)).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    ref = pl.pallas_call(
        functools.partial(j_attn._flash_kernel, scale=scale, kv_len=sk, block_k=bk),
        out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
        grid=(b, sq // bq),
        in_specs=[pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, sk, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, sk, d), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
        interpret=True,
    )(*map(jnp.asarray, (q, k, v)))
    assert p_attn.flash_tiles(sq, sk, d, bq, bk)
    got = p_attn.flash_attention(_t(q), _t(k), _t(v), scale, bq, bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(p_attn.flash_attention_reference(_t(q), _t(k), _t(v)).numpy(),
                               got.numpy(), atol=0, rtol=0)


def test_each_plain_version_rounds_where_its_kernel_rounds():
    """In bf16 K11's plain version rounds the probabilities and K12's does
    not: they differ from each other, and the unrounded one is the closer
    to an f64 attention."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(9, 2, 256, 128))
    exact = torch.softmax(q.double() @ k.double().transpose(1, 2) / 128**0.5, -1) @ v.double()
    one = p_attn.oneshot_attention_reference(q, k, v)
    flash = p_attn.flash_attention_reference(q, k, v)
    assert not torch.equal(one, flash)
    assert (flash.double() - exact).abs().mean() <= (one.double() - exact).abs().mean()
    # on a CPU tensor the entry takes the unrounded version where the shapes tile
    assert torch.equal(p_attn.flash_attention(q, k, v), flash)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_route_head_dims_match_jax(d):
    """The probe's (B, S, 8, D) self-attention lies on the flash route in
    both packages; on the CPU both run their plain attention. f32: atol 2e-5."""
    q, k, v = _qkv(10, 2, 256, 8, d)
    assert p_attn.flash_route(_t(q), _t(k))
    ref = j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    got = p_attn.dot_product_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

_ATT = {"spatial": [(2, 64, 2, 8)], "temporal": [(4, 16, 2, 8)]}
_LEVELS = [(2, 8, 32)]
_MM = [(64, 32, 48), (64, 48, 16)]


def _tiny_config():
    unet = pcfg.UNet3DConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                             norm_num_groups=8, cross_attention_dim=16, attention_head_dim=4,
                             motion_module=pcfg.MotionModuleConfig(num_attention_heads=4))
    return pcfg.LatentSyncConfig(
        unet=unet, vae=pcfg.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                                      norm_num_groups=4),
        whisper=pcfg.WhisperConfig(n_audio_state=16, n_audio_head=2, n_audio_layer=1),
        data=pcfg.DataConfig(resolution=64))


# mode → (arguments at toy shapes, measurement lines expected)
_MODE_ARGS = {
    "attn": (lambda: ((_ATT,), {}), 3),
    "spat": (lambda: ((_ATT,), {}), 6),
    "conv": (lambda: ((_LEVELS,), {}), 1),
    "gn": (lambda: ((_LEVELS,), {}), 1),
    "gn2": (lambda: ((_LEVELS,), {}), 2),
    "gn3": (lambda: ((_LEVELS,), {}), 2),
    "int8": (lambda: ((_MM, _LEVELS), {}), 9),
    "ffn": (lambda: (([(64, 32)],), {}), 4),
    "ffn8": (lambda: (([(64, 32)],), {}), 2),
    "qmm": (lambda: ((_MM,), {}), 4),
    "unet": (lambda: ((_tiny_config(),), {"iters": 1}), 2),
    "ablate": (lambda: ((_tiny_config(),), {"iters": 1}), 5),
    "tmod": (lambda: ((_tiny_config(),), {"levels": ((8, 32, 2),), "iters": 1}), 2),
    "denoise": (lambda: ((_tiny_config(),), {"steps": 2, "rounds": 1}), 1),
    "vae": (lambda: ((_tiny_config(),), {"batches": (2,), "rounds": 1}), 2),
}


def _finite(rec) -> bool:
    nums = [v for v in rec.values() if isinstance(v, (int, float))]
    return bool(nums) and all(math.isfinite(v) for v in nums)


@pytest.mark.parametrize("mode", sorted(mp.MODES))
def test_probe_mode_prints_finite_json_lines(mode, capsys):
    make, n_lines = _MODE_ARGS[mode]
    args, kwargs = make()
    mp.run(mp.Probe("cpu", w=1, iters=1), mode, *args, **kwargs)
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(recs) == n_lines
    for rec in recs:
        assert isinstance(rec["name"], str) and _finite(rec), rec
        # a CPU time is never printed under the name of a device metric
        assert "ms" not in rec and not any(key.startswith("share_of") for key in rec)
    assert all(rec["gflops"] > 0 for rec in recs if "gflops" in rec)


def test_every_mode_of_the_reference_is_ported_or_named_unported():
    reference_modes = {"attn", "spat", "conv", "gn", "spatq", "tempq", "gn2", "gn3", "int8",
                       "ffn", "ffn8", "qmm", "unet", "ablate", "tmod", "dcread", "denoise", "vae"}
    assert set(mp.MODES) | set(mp.UNPORTED) == reference_modes
    assert set(_MODE_ARGS) == set(mp.MODES)


@pytest.mark.parametrize("mode", sorted(mp.UNPORTED))
def test_unported_probe_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp.run(mp.Probe("cpu", w=1, iters=1), mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp.main(["--device", "cpu", "--which", mode])


def test_probe_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mp.main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_probe_main_on_the_cpu(monkeypatch, capsys):
    """``main`` with ``--device cpu`` drives a mode end to end (its shape
    table cut to toy size here)."""
    monkeypatch.setattr(mp, "attention_shapes", lambda p: _ATT)
    assert mp.main(["--device", "cpu", "--which", "spat", "--w", "1", "--iters", "2"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["name"] for r in recs][:3] == ["spat_lane_sliced_S64_C16",
                                             "spat_oneshot_transposed_S64_C16",
                                             "spat_flash_S64_C16"]
    assert all(_finite(r) and r["device"] == "cpu" for r in recs)
    with pytest.raises(ValueError, match="unknown mode"):
        mp.main(["--device", "cpu", "--which", "nope"])


def test_count_ops_counts_products_and_kernel_launches():
    x, w = torch.randn(8, 16), torch.randn(32, 16)
    assert mp.count_ops(lambda: torch.nn.functional.linear(x, w)) == 2 * 8 * 16 * 32
    # a kernel launch is counted from its arguments (here: K9's m, c, inner)
    ops = mp._KERNEL_OPS["ls_qkv_proj"]((0,) * 7 + (128, 320, 320, 0))
    assert ops == 6 * 128 * 320 * 320
