"""The port's kernel-bearing ops against the JAX package, on the CPU.

Each op of ``latentsync_tpu_torch.ops`` that holds a CUDA kernel runs its
plain version here (CPU tensors) and is held against the JAX function it
replaces, on the same seeded numpy inputs in float32: against the Pallas
kernel itself in interpret mode at one tiny shape per mode, and against
the JAX plain reference elsewhere. Tolerance: atol 2e-5 / rtol 1e-5 on
O(1) outputs — both sides are f32 with different summation orders.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_kernels.py``.
"""

import ast
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu.ops import temporal_attention as j_ta
from latentsync_tpu.ops.attention import dot_product_attention as j_dpa
from latentsync_tpu.ops.ddim import DDIMScheduler as JDDIM
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.ops import groupnorm as p_gn
from latentsync_tpu_torch.ops import temporal_attention as p_ta
from latentsync_tpu_torch.ops.attention import dot_product_attention as p_dpa
from latentsync_tpu_torch.ops.ddim import DDIMScheduler as PDDIM

ATOL, RTOL = 2e-5, 1e-5


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ffn_inputs(rng, m, c):
    inner = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w_up = (rng.standard_normal((c, 2 * inner)) / math.sqrt(c)).astype(np.float32)
    b_up = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w_dn = (rng.standard_normal((inner, c)) / math.sqrt(inner)).astype(np.float32)
    b_dn = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ls = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w_up, b_up, w_dn, b_dn, ls, lb


def _port_ffn(x, w_up, b_up, w_dn, b_dn, ls, lb, has_ln, residual):
    # flax (in, out) kernels → torch nn.Linear (out, in) weights
    return p_ffn.geglu_ffn(_t(x), _t(w_up.T), _t(b_up), _t(w_dn.T), _t(b_dn),
                           _t(ls) if has_ln else None, _t(lb) if has_ln else None,
                           residual=residual).numpy()


def test_geglu_ffn_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(0)
    x, w_up, b_up, w_dn, b_dn, ls, lb = _ffn_inputs(rng, 128, 64)
    ref = j_ffn.geglu_ffn(jnp.asarray(x), w_up, b_up, w_dn, b_dn, ln_scale=ls,
                          ln_bias=lb, residual=True, interpret=True)
    # the Pallas kernel's Abramowitz-Stegun erf is within 1e-6 of erf
    _close(_port_ffn(x, w_up, b_up, w_dn, b_dn, ls, lb, True, True), ref, atol=1e-5)


@pytest.mark.parametrize("has_ln,residual", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("m,c", [(48, 32), (200, 40)])
def test_geglu_ffn_matches_xla_reference(m, c, has_ln, residual):
    rng = np.random.default_rng(m + c)
    x, w_up, b_up, w_dn, b_dn, ls, lb = _ffn_inputs(rng, m, c)
    inner = 4 * c
    ref = j_ffn._geglu_xla_full(jnp.asarray(x), ls, lb, w_up[:, :inner], w_up[:, inner:],
                                b_up[:inner], b_up[inner:], w_dn, b_dn, has_ln, residual,
                                1e-6)
    _close(_port_ffn(x, w_up, b_up, w_dn, b_dn, ls, lb, has_ln, residual), ref)


def _block_inputs(rng, b, s, c):
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    ws = [(rng.standard_normal((c, c)) / math.sqrt(c)).astype(np.float32) for _ in range(4)]
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ls = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    pe = rng.standard_normal((s, c)).astype(np.float32)
    return x, ls, lb, ws, bo, pe


def _port_block(x, ls, lb, ws, bo, heads, temporal, pe):
    wq, wk, wv, wo = (_t(w.T) for w in ws)
    return p_ab.self_attention_block(
        _t(x), _t(ls), _t(lb), wq, wk, wv, wo, _t(bo), heads, temporal=temporal,
        pe=None if pe is None else _t(pe)).numpy()


@pytest.mark.parametrize("temporal,b,s,c,heads", [
    (True, 8, 16, 32, 4),     # head-major fold of the temporal mode
    (False, 2, 64, 32, 4),    # heads on lanes, spatial mode
])
def test_self_attention_block_matches_pallas_kernel_interpret(temporal, b, s, c, heads):
    rng = np.random.default_rng(s)
    x, ls, lb, ws, bo, pe = _block_inputs(rng, b, s, c)
    pe = pe if temporal else None
    ref = j_ab.self_attention_block(jnp.asarray(x), ls, lb, *ws, bo, heads,
                                    temporal=temporal, pe=pe, interpret=True)
    _close(_port_block(x, ls, lb, ws, bo, heads, temporal, pe), ref)


@pytest.mark.parametrize("temporal,b,s,c,heads,with_pe", [
    (True, 6, 16, 48, 2, True),
    (True, 4, 12, 32, 4, False),
    (False, 3, 40, 64, 8, False),
])
def test_self_attention_block_matches_xla_reference(temporal, b, s, c, heads, with_pe):
    rng = np.random.default_rng(c)
    x, ls, lb, ws, bo, pe = _block_inputs(rng, b, s, c)
    pe = pe if with_pe else None
    scale = 1.0 / math.sqrt(c // heads)
    ref = j_ab._xla_block(jnp.asarray(x), ls, lb, pe, *ws, bo, heads, temporal, 1e-6, scale)
    _close(_port_block(x, ls, lb, ws, bo, heads, temporal, pe), ref)


def test_cross_attention_block_matches_xla_reference():
    rng = np.random.default_rng(11)
    b, s, sk, c, cc, heads = 3, 20, 7, 32, 24, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    ctx = rng.standard_normal((b, sk, cc)).astype(np.float32)
    wq = (rng.standard_normal((c, c)) / math.sqrt(c)).astype(np.float32)
    wk, wv = ((rng.standard_normal((cc, c)) / math.sqrt(cc)).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((c, c)) / math.sqrt(c)).astype(np.float32)
    bo = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ls = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = j_ab._xla_cross_block(jnp.asarray(x), jnp.asarray(ctx), ls, lb, wq, wk, wv, wo,
                                bo, heads, 1e-6, 1.0 / math.sqrt(c // heads))
    got = p_ab.cross_attention_block(_t(x), _t(ls), _t(lb), _t(ctx), _t(wq.T), _t(wk.T),
                                     _t(wv.T), _t(wo.T), _t(bo), heads)
    _close(got.numpy(), ref)


def _qkv(rng, b, s, hd):
    return [rng.standard_normal((b, s, hd)).astype(np.float32) for _ in range(3)]


def test_temporal_attention_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 16, 16, 32)
    ref = j_ta.temporal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                                  block=8, interpret=True)
    _close(p_ta.temporal_attention(_t(q), _t(k), _t(v), 4).numpy(), ref)


@pytest.mark.parametrize("b,f,heads,d", [(5, 16, 8, 5), (3, 9, 2, 16)])
def test_temporal_attention_matches_xla_reference(b, f, heads, d):
    rng = np.random.default_rng(b * f)
    q, k, v = _qkv(rng, b, f, heads * d)
    scale = 1.0 / math.sqrt(d)
    ref = j_ta._temporal_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, scale)
    _close(p_ta.temporal_attention(_t(q), _t(k), _t(v), heads).numpy(), ref)


def test_spatial_attention_matches_pallas_kernel_interpret():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 32)
    ref = j_ta.spatial_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                                 interpret=True)
    _close(p_ta.spatial_attention(_t(q), _t(k), _t(v), 4).numpy(), ref)


@pytest.mark.parametrize("b,s,heads,d", [(2, 100, 4, 10), (1, 16, 8, 20)])
def test_spatial_attention_matches_xla_reference(b, s, heads, d):
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, b, s, heads * d)
    ref = j_ta._spatial_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                            1.0 / math.sqrt(d))
    _close(p_ta.spatial_attention(_t(q), _t(k), _t(v), heads).numpy(), ref)


def test_dot_product_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 11, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, 7, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, 7, 4, 8)).astype(np.float32)
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(p_dpa(_t(q), _t(k), _t(v)).numpy(), ref)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(monkeypatch):
    rng = np.random.default_rng(4)
    counters = (p_ffn.geglu_ffn, p_ab.self_attention_block, p_ta.temporal_attention,
                p_ta.spatial_attention, p_attn.dot_product_attention,
                p_ab.cross_attention_block, p_gn.group_norm_silu,
                p_gn.group_norm_silu_streaming)
    before = [fn.launches for fn in counters]
    q, k, v = _qkv(rng, 2, 16, 16)
    p_ta.temporal_attention(_t(q), _t(k), _t(v), 2)
    p_ta.spatial_attention(_t(q), _t(k), _t(v), 2)
    x, w_up, b_up, w_dn, b_dn, ls, lb = _ffn_inputs(rng, 8, 16)
    _port_ffn(x, w_up, b_up, w_dn, b_dn, ls, lb, True, True)
    # the new wrappers at shapes their kernels take on the card, with the
    # fused-kernel switches on
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")
    monkeypatch.setenv("LATENTSYNC_PALLAS_GN", "1")
    q, k, v = (_t(a).reshape(2, 256, 1, 16) for a in _qkv(rng, 2, 256, 16))
    assert p_attn.flash_route(q, k)
    p_attn.dot_product_attention(q, k, v)
    xb, ls, lb, ws, bo, _ = _block_inputs(rng, 2, 16, 16)
    ctx = _t(rng.standard_normal((2, 8, 16)).astype(np.float32))
    assert p_ab.cross_fused_route(2, 16, 8, 16, 16, 16)
    p_ab.cross_attention_block(_t(xb), _t(ls), _t(lb), ctx, *(_t(w.T) for w in ws), _t(bo), 2)
    g = _t(rng.standard_normal((2, 16, 4, 4, 4)).astype(np.float32))
    p_gn.group_norm_silu(g, torch.ones(16), torch.zeros(16), 4)
    p_gn.group_norm_silu_streaming(g, torch.ones(16), torch.zeros(16), 4)
    assert [fn.launches for fn in counters] == before


# (B·S, S or F, C, heads, temporal) of every self-attention block in the
# flagship UNet at window batch 2 × CFG 2 (B = 4), 32² latents
_FLAGSHIP_BLOCKS = [
    (4 * 1024, 16, 320, True), (4 * 256, 16, 640, True), (4 * 64, 16, 1280, True),
    (4 * 16, 16, 1280, True), (4 * 16, 1024, 320, False), (4 * 16, 256, 640, False),
    (4 * 16, 64, 1280, False), (4 * 16, 16, 1280, False),
]


@pytest.mark.parametrize("b,s,c,temporal", _FLAGSHIP_BLOCKS)
def test_fused_block_routing_matches_the_reference(b, s, c, temporal):
    """The port launches its fused block chain exactly where the reference
    launched its fused Pallas block, and its K3/K4 cores elsewhere."""
    heads = 8
    ref_fused = (j_ab._pick_block(b, s, c, c, heads, temporal) > 0
                 and ((8 <= s and s * heads <= 512) if temporal else 16 <= s <= 1024))
    assert p_ab.fused_route(s, c, c, temporal) == ref_fused


def test_ddim_tables_and_step_match_jax():
    j, p = JDDIM.create(), PDDIM.create()
    for a, b in zip(j.step_tables(20), p.step_tables(20)):
        np.testing.assert_array_equal(a, b)
    _, at, ap = p.step_tables(20)
    rng = np.random.default_rng(5)
    eps, x = (rng.standard_normal((2, 4, 3, 3)).astype(np.float32) for _ in range(2))
    ref = JDDIM.step(jnp.asarray(eps), jnp.asarray(x), at[3], ap[3])
    _close(PDDIM.step(_t(eps), _t(x), at[3], ap[3]).numpy(), ref, atol=1e-6)


_FOREIGN = ("jax", "flax", "latentsync_tpu")


def test_port_imports_no_jax():
    """Importing the port's entry points (pipeline, server, probe) loads no
    module of jax, flax or the JAX package."""
    code = ("import sys, latentsync_tpu_torch.serving.api, latentsync_tpu_torch.pipelines."
            "lipsync, latentsync_tpu_torch.scripts.micro_probe; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {_FOREIGN!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def _port_sources():
    root = pathlib.Path(p_ffn.__file__).resolve().parents[2]
    return [root / "chip_smoke.py", *sorted((root / "latentsync_tpu_torch").rglob("*.py"))]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_imports_nothing_of_the_jax_package(path):
    """No import statement anywhere in the port's sources or in
    ``chip_smoke.py``, at any depth (imports inside functions included),
    names jax, flax or ``latentsync_tpu``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in _FOREIGN]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_native_binding_matches_the_jax_package_bit_for_bit():
    """The port's own ctypes binding of ``native/restore.cpp`` against the
    JAX package's, on the same seeded frames: all three functions."""
    from latentsync_tpu.utils import native as j_native
    from latentsync_tpu_torch.utils import native as p_native

    assert p_native.restore_lib() is p_native
    assert j_native.get_lib() is not None
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (3, 96, 80, 3), dtype=np.uint8)
    faces = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    mats = np.stack([np.array([[0.9, 0.05, -6.0 + i], [-0.04, 1.1, -9.0]]) for i in range(3)])
    np.testing.assert_array_equal(p_native.resize_frames_native(frames, (40, 56)),
                                  j_native.resize_frames_native(frames, (40, 56)))
    np.testing.assert_array_equal(p_native.restore_frames_native(frames, faces, mats),
                                  j_native.restore_frames_native(frames, faces, mats))
    got = p_native.restore_frames_const_native(frames, faces, mats[0])
    np.testing.assert_array_equal(got, j_native.restore_frames_const_native(frames, faces,
                                                                            mats[0]))
    # the cached plan gives the same frames again, and copy=False pastes in place
    scratch = frames.copy()
    assert p_native.restore_frames_const_native(scratch, faces, mats[0], copy=False) is scratch
    np.testing.assert_array_equal(scratch, got)
    assert not np.array_equal(got, frames)


def test_pipeline_without_a_device_means_cuda(monkeypatch):
    """``LipsyncPipeline(device=None)`` runs on the card or raises: models
    built on the CPU do not pull the pipeline there."""
    from latentsync_tpu_torch.pipelines import lipsync

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Unused:
        def __getattr__(self, name):
            raise AssertionError("the pipeline touched a model before checking the device")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lipsync.LipsyncPipeline(Unused(), Unused(), Unused())
