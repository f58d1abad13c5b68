"""Gradients through the port's kernel wrappers against the JAX package.

Each wrapper with a gradient (K1 ``geglu_ffn``, K2 ``self_attention_block``
in both modes, K3 ``temporal_attention``, K4 ``spatial_attention`` and the
flash route of ``dot_product_attention``) goes through its
``torch.autograd.Function`` on the CPU too: its forward is the plain
version there and its backward the composition the JAX package's
``custom_vjp`` differentiates. Here the forward and the input and weight
gradients are held against ``jax.vjp`` of the JAX kernel entry run in
interpret mode, as its own tests run it, so that the ``custom_vjp`` rule is
what is compared (the flash route: the JAX package's off-TPU einsum, which
is that route's composed form); each Function passes
``torch.autograd.gradcheck`` in float64; the wrappers without a gradient
refuse a call under grad (on the card: ``tests/test_torch_train_kernels.py``);
and a torch mirror of ``csrc/flash_attention_bwd.cu``'s tiling (the
residual forward's lse, delta from the bf16 output, 64-row blocks over
streamed tiles of 64 rows, of 32 at D = 512 with s and dp summed from two
column halves, at D = 64 each streamed tile stored and read back through
the 128-byte swizzle, bf16 probabilities and dS) agrees with the plain
backward and with ``jax.vjp``; with delta planted at 0, or at D = 64 with
loads that ignore the swizzle, it must fail. f32 throughout, tolerances
stated at each check.
"""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu.ops import temporal_attention as j_ta
from latentsync_tpu.ops.attention import dot_product_attention as j_dpa
from latentsync_tpu_torch.ops import _build
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.ops import temporal_attention as p_ta

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)


# f32 forward and gradients: the two packages sum in other orders (and the
# Pallas GEGLU kernel's erf is within 1e-6 of erf), nothing else differs
ATOL, RTOL = 2e-5, 2e-5


def _t(a, grad=True):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _grads(out, inputs, cot):
    out.backward(torch.from_numpy(cot))
    return [t.grad.numpy() for t in inputs]


def _rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("has_ln,residual", [(True, True), (False, False)])
def test_geglu_ffn_vjp_matches_the_jax_custom_vjp(has_ln, residual):
    rng = np.random.default_rng(1)
    m, c = 128, 64  # a shape the Pallas kernel tiles (M % 128, inner % 256)
    x, w_up, w_dn = _rand(rng, m, c), _rand(rng, c, 8 * c, s=c**-0.5), \
        _rand(rng, 4 * c, c, s=(4 * c) ** -0.5)
    b_up, b_dn = _rand(rng, 8 * c, s=0.1), _rand(rng, c, s=0.1)
    ls, lb = 1 + _rand(rng, c, s=0.1), _rand(rng, c, s=0.1)
    cot = _rand(rng, m, c)
    j_in = [x, w_up, b_up, w_dn, b_dn] + ([ls, lb] if has_ln else [])

    def jf(x, w_up, b_up, w_dn, b_dn, *ln):
        return j_ffn.geglu_ffn(x, w_up, b_up, w_dn, b_dn, *(ln or (None, None)),
                               residual=residual, interpret=True)

    ref, vjp = jax.vjp(jf, *map(jnp.asarray, j_in))
    ref_grads = vjp(jnp.asarray(cot))
    tx, twu, tbu, twd, tbd = _t(x), _t(w_up.T), _t(b_up), _t(w_dn.T), _t(b_dn)
    ln = [_t(ls), _t(lb)] if has_ln else []
    out = p_ffn.geglu_ffn(tx, twu, tbu, twd, tbd, *(ln or [None, None]), residual=residual)
    assert out.grad_fn is not None
    _close(out.detach().numpy(), ref)
    got = _grads(out, [tx, twu, tbu, twd, tbd] + ln, cot)
    got[1], got[3] = got[1].T, got[3].T  # nn.Linear (out, in) → flax (in, out)
    for g, r in zip(got, ref_grads):
        _close(g, r, atol=1e-4)


# ---------------------------------------------------------------------------
# K2, K3, K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temporal,b,s,c,heads", [
    (True, 8, 16, 32, 4),   # the fused temporal mode, with the positional encoding
    (False, 2, 64, 32, 4),  # the fused spatial mode
])
def test_self_attention_block_vjp_matches_the_jax_custom_vjp(temporal, b, s, c, heads):
    rng = np.random.default_rng(s)
    x = _rand(rng, b, s, c)
    ws = [_rand(rng, c, c, s=c**-0.5) for _ in range(4)]
    bo, ls, lb = _rand(rng, c, s=0.1), 1 + _rand(rng, c, s=0.1), _rand(rng, c, s=0.1)
    pe = _rand(rng, s, c) if temporal else None
    cot = _rand(rng, b, s, c)

    def jf(x, ls, lb, wq, wk, wv, wo, bo, *pe):
        return j_ab.self_attention_block(x, ls, lb, wq, wk, wv, wo, bo, heads,
                                         temporal=temporal, pe=pe[0] if pe else None,
                                         interpret=True)

    j_in = [x, ls, lb, *ws, bo] + ([pe] if temporal else [])
    ref, vjp = jax.vjp(jf, *map(jnp.asarray, j_in))
    ref_grads = vjp(jnp.asarray(cot))
    tx, tls, tlb, tbo = _t(x), _t(ls), _t(lb), _t(bo)
    tws = [_t(w.T) for w in ws]
    tpe = [_t(pe)] if temporal else []
    out = p_ab.self_attention_block(tx, tls, tlb, *tws, tbo, heads, temporal=temporal,
                                    pe=tpe[0] if tpe else None)
    assert out.grad_fn is not None
    _close(out.detach().numpy(), ref)
    got = _grads(out, [tx, tls, tlb, *tws, tbo] + tpe, cot)
    got[3:7] = [g.T for g in got[3:7]]
    for g, r in zip(got, ref_grads):
        _close(g, r, atol=1e-4)


def _attn_vjp(jfn, pfn, shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (_rand(rng, *shape) for _ in range(4))
    ref, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = pfn(tq, tk, tv)
    assert out.grad_fn is not None
    _close(out.detach().numpy(), ref)
    for g, r in zip(_grads(out, [tq, tk, tv], cot), vjp(jnp.asarray(cot))):
        _close(g, r, atol=1e-4)


def test_temporal_attention_vjp_matches_the_jax_custom_vjp():
    _attn_vjp(lambda q, k, v: j_ta.temporal_attention(q, k, v, 4, block=8, interpret=True),
              lambda q, k, v: p_ta.temporal_attention(q, k, v, 4), (16, 16, 32), 3)


def test_spatial_attention_vjp_matches_the_jax_custom_vjp():
    _attn_vjp(lambda q, k, v: j_ta.spatial_attention(q, k, v, 4, interpret=True),
              lambda q, k, v: p_ta.spatial_attention(q, k, v, 4), (2, 64, 32), 4)


@pytest.mark.parametrize("shape", [(2, 256, 1, 16), (1, 384, 2, 8),
                                   (2, 256, 2, 64), (1, 384, 1, 64)])
def test_flash_route_vjp_matches_jax(shape):
    """S >= 256, a multiple of 128: the route of the VAE mid-block (and of
    K4's composed gradient at S = 1024), and at D = 64 CodeFormer's
    transformer under grad in its training."""
    assert p_attn.flash_route(torch.empty(shape), torch.empty(shape))
    _attn_vjp(j_dpa, p_attn.dot_product_attention, shape, 5)


# ---------------------------------------------------------------------------
# gradcheck in float64
# ---------------------------------------------------------------------------


def _f64(rng, *shape, s=1.0):
    return torch.from_numpy(s * rng.standard_normal(shape)).requires_grad_(True)


def _gradcheck(fn, *inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True)


def test_gradcheck_geglu_ffn():
    rng = np.random.default_rng(10)
    c = 8
    _gradcheck(lambda *a: p_ffn.geglu_ffn(*a, residual=True), _f64(rng, 6, c),
               _f64(rng, 8 * c, c, s=0.3), _f64(rng, 8 * c, s=0.1), _f64(rng, c, 4 * c, s=0.2),
               _f64(rng, c, s=0.1), 1 + _f64(rng, c, s=0.1), _f64(rng, c, s=0.1))


@pytest.mark.parametrize("temporal", [True, False])
def test_gradcheck_self_attention_block(temporal):
    rng = np.random.default_rng(11)
    c = 8
    ws = [_f64(rng, c, c, s=0.3) for _ in range(4)]

    def fn(x, ls, lb, wq, wk, wv, wo, bo, pe):
        return p_ab.self_attention_block(x, ls, lb, wq, wk, wv, wo, bo, 2, temporal=temporal,
                                         pe=pe if temporal else None)

    _gradcheck(fn, _f64(rng, 2, 4, c), 1 + _f64(rng, c, s=0.1), _f64(rng, c, s=0.1), *ws,
               _f64(rng, c, s=0.1), _f64(rng, 4, c))


@pytest.mark.parametrize("which", ["temporal", "spatial"])
def test_gradcheck_attention_cores(which):
    rng = np.random.default_rng(12)
    fn = p_ta.temporal_attention if which == "temporal" else p_ta.spatial_attention
    _gradcheck(lambda q, k, v: fn(q, k, v, 2), *(_f64(rng, 2, 5, 8) for _ in range(3)))


def test_gradcheck_flash_route_function():
    rng = np.random.default_rng(13)
    _gradcheck(lambda q, k, v: p_attn._FlashRoute.apply(q, k, v, 0.5),
               *(_f64(rng, 1, 8, 2, 4) for _ in range(3)))


# ---------------------------------------------------------------------------
# the wrappers without a gradient
# ---------------------------------------------------------------------------


def test_check_cuda_refuses_inputs_that_require_grad_under_grad():
    """The guard every kernel launch passes (here on CPU tensors, where it
    raises before any device check): under grad with an input that requires
    grad it raises; with grad off, or no such input, it does not."""
    x = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    y = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no gradient"):
        _build.check_cuda("k", y, x)
    with pytest.raises(RuntimeError, match="no gradient"):
        _build.refuse_grad("k", None, x)
    _build.refuse_grad("k", y, None)
    with torch.no_grad():
        _build.refuse_grad("k", x)


def _launchers():
    """(module, function) of every function of the port's ops that launches
    a kernel (calls ``_build.call``)."""
    root = pathlib.Path(p_ffn.__file__).resolve().parent
    out = []
    for path in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(n, ast.Attribute) and n.attr == "call"
                    and isinstance(n.value, ast.Name) and n.value.id == "_build"
                    for n in ast.walk(node)):
                out.append((path.name, node))
    return out


@pytest.mark.parametrize("name,fn", _launchers(), ids=lambda v: getattr(v, "name", v))
def test_every_kernel_launch_passes_the_grad_guard(name, fn):
    """No launch can return a tensor cut off from autograd: each launcher
    calls ``check_cuda`` or ``refuse_grad`` first (inside the Functions of
    K1-K4 and the flash route grad is off, so the guard passes there)."""
    calls = [n.func.attr for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and isinstance(n.func.value, ast.Name)
             and n.func.value.id == "_build"]
    first = calls.index("call")
    assert {"check_cuda", "refuse_grad"} & set(calls[:first]), f"{name}:{fn.name}"


def test_int8_routes_refuse_grad_on_the_card():
    """The int8 routes no longer refuse grad: each reaches its int8 work
    only inside its straight-through Function (``QConvSTE``, ``QDenseSTE``),
    whose forward runs with grad off. What still refuses on the card is
    K8's launcher called directly under grad (``check_cuda`` before its
    launch); ``dense_with_params`` hands it to ``QDenseSTE``."""
    from latentsync_tpu_torch.ops import qconv, qmm

    def source(module, name):
        return ast.unparse(next(n for n in ast.walk(ast.parse(
            pathlib.Path(module.__file__).read_text()))
            if isinstance(n, ast.FunctionDef) and n.name == name))

    assert "QConvSTE.apply" in source(qconv, "quantized_conv2d")
    assert "QDenseSTE.apply" in source(qconv, "_qdense_xla")
    assert "QDenseSTE.apply(quantized_matmul" in source(qconv, "dense_with_params")
    assert "refuse_grad" not in pathlib.Path(qconv.__file__).read_text()
    assert "_build.check_cuda" in source(qmm, "quantized_matmul")
    x = torch.ones(4, 8, requires_grad=True)
    assert type(qconv._qdense_xla(x, torch.ones(8, 8), None).grad_fn).__name__ == \
        "QDenseSTEBackward"


# ---------------------------------------------------------------------------
# a mirror of csrc/flash_attention_bwd.cu's tiling
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
TOL_REL = 2.0**-6  # chip_smoke.py's tolerance for the kernel, per output
BWD_REL_L2_TOL = 1e-2  # and its relative L2 bound for the backward, per output


def _bf16(t):
    return t.to(torch.bfloat16).float()


def flash_fwd_residual(q, k, v, scale):
    """The residual forward of one head as the core computes it: the online
    softmax over key tiles of 64 (D <= 160) or 32 (D = 512), a running max m
    of the raw logits and a sum l of p = 2^(s c - m c), c = scale log2(e);
    o = sum bf16(p) v / l rounded to bf16, and lse = m c + log2(l) (base 2)."""
    s_len = q.shape[0]
    kt = 32 if q.shape[1] == 512 else 64
    c = scale * LOG2E
    m = torch.full((s_len,), -math.inf)
    l, acc = torch.zeros(s_len), torch.zeros(q.shape)
    for k0 in range(0, s_len, kt):
        logits = q @ k[k0:k0 + kt].T
        x = torch.maximum(m, logits.max(dim=-1).values)
        corr = torch.exp2((m - x) * c)
        l, acc, m = l * corr, acc * corr[:, None], x
        p = torch.exp2(logits * c - (m * c)[:, None])
        l = l + p.sum(dim=-1)
        acc = acc + _bf16(p) @ v[k0:k0 + kt]
    return _bf16(acc / l[:, None]), m * c + torch.log2(l)


def sw128_offset(r, c):
    """Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
    (``csrc/wgmma.cuh``)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def swizzled_stream_maps(rows=64, ignore_swizzle=False):
    """Where the D = 64 row kernel's operands come from: each streamed tile
    (rows x 64 bf16, one 128-byte atom a row) is stored by the loads at
    ``sw128_offset(row, chunk)`` (``Tile<64>::SW``), and the matrix unit
    reads it through the swizzle (bits 4-6 of a byte address XOR bits
    7-9) as the K-major B of s and dp, k-step kk from ``Tile::k_step(kk)``
    = 32 kk on (16 columns of D, row n at 128 n), and as the MN-major B of
    the output products, k-step j from ``Tile::v_step(j)`` = 2048 j on (16
    rows, column n at 2 n). Returns (K-major, MN-major) maps: the element of
    the tile (row * 64 + col, flat) each operand position reads; both are
    the identity where stores and reads agree. ``ignore_swizzle`` plants a
    fault: the loads store at the linear 128 row + 16 chunk."""
    smem = np.full(rows * 64, -1, np.int64)
    ids = np.arange(rows * 64).reshape(rows, 64)
    for r in range(rows):
        for c in range(8):
            dst = r * 128 + c * 16 if ignore_swizzle else sw128_offset(r, c)
            smem[dst // 2:dst // 2 + 8] = ids[r, 8 * c:8 * c + 8]
    assert (smem >= 0).all()

    def read(addr):
        return smem[(addr ^ (((addr >> 7) & 7) << 4)) // 2]

    n, c = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    kmaj = np.concatenate([read(32 * kk + n * 128 + c * 2) for kk in range(4)], axis=1)
    kr, col = np.meshgrid(np.arange(16), np.arange(64), indexing="ij")
    mnmaj = np.concatenate([read(2048 * j + kr * 128 + col * 2) for j in range(rows // 16)])
    return torch.from_numpy(kmaj), torch.from_numpy(mnmaj)


def flash_bwd_tiled(q, k, v, do, scale, plant_zero_delta=False, ignore_swizzle=False):
    """(dq, dk, dv) of one head as the two launches compute them from the
    residual forward's o and lse: delta = rowsum(o · do) (jax's di, from the
    bf16 output); P = 2^(s c - lse); dS = P (dp - delta) scale; f32 products
    of bf16 inputs. Launch 1: 64-row query blocks over streamed key tiles,
    dQ += bf16(dS) k; launch 2: 64-key blocks over streamed query tiles,
    dV += bf16(P^T) do, dK += bf16(dS^T) q. Streamed tiles of 64 rows (D =
    40 and 80; D zero-padded to the k-step, which adds exact zeros), of 32
    at D = 512, where s and dp are the sum of the two column halves' partial
    products (half 0 + half 1, the addition the cluster's blocks make).
    At D = 64 every streamed tile reaches both of its products through the
    swizzled stores and descriptor reads of ``swizzled_stream_maps``.
    Outputs rounded to bf16. ``plant_zero_delta`` plants a fault: delta = 0;
    ``ignore_swizzle`` another: the D = 64 loads store without the swizzle."""
    s_len, d = q.shape
    st = 32 if d == 512 else 64
    o, lse = flash_fwd_residual(q, k, v, scale)
    c = scale * LOG2E
    delta = (o * do).sum(dim=-1) * (0.0 if plant_zero_delta else 1.0)
    maps = swizzled_stream_maps(st, ignore_swizzle) if d == 64 else None

    def streamed(x):
        """(K-major, MN-major) operand of a streamed tile x (st, D)."""
        if maps is None:
            return x, x
        flat = x.reshape(-1)
        return flat[maps[0]], flat[maps[1]]

    def partial_sum(a, b):
        if d != 512:
            return a @ b.T
        return a[:, :256] @ b[:, :256].T + a[:, 256:] @ b[:, 256:].T

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, s_len, 64):
        rows = slice(r0, r0 + 64)
        for t0 in range(0, s_len, st):
            keys = slice(t0, t0 + st)
            (kk, kn), (vk, _) = streamed(k[keys]), streamed(v[keys])
            p = torch.exp2(partial_sum(q[rows], kk) * c - lse[rows, None])
            ds = p * (partial_sum(do[rows], vk) - delta[rows, None]) * scale
            dq[rows] += _bf16(ds) @ kn
    for r0 in range(0, s_len, 64):
        keys = slice(r0, r0 + 64)
        for t0 in range(0, s_len, st):
            rows = slice(t0, t0 + st)
            (qk, qn), (dok, don) = streamed(q[rows]), streamed(do[rows])
            pt = torch.exp2(partial_sum(k[keys], qk) * c - lse[None, rows])
            dst = pt * (partial_sum(v[keys], dok) - delta[None, rows]) * scale
            dv[keys] += _bf16(pt) @ don
            dk[keys] += _bf16(dst) @ qn
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _bwd_within(got, plain):
    """(max-abs check, relative-L2 check) of one gradient against its plain
    counterpart, as chip_smoke.py holds the kernel."""
    tol = TOL_REL * max(1.0, float(plain.abs().max()))
    rel = float((got - plain).norm() / plain.norm())
    return float((got - plain).abs().max()) <= tol, rel <= BWD_REL_L2_TOL


def _bwd_case(s, d):
    gen = torch.Generator().manual_seed(s + d)
    q, k, v, do = (_bf16(torch.randn(s, d, generator=gen)) for _ in range(4))
    return q, k, v, do, d**-0.5


FLASH_BWD_CASES = [(64, 40), (128, 80), (128, 40), (256, 40), (256, 80), (128, 512), (256, 512),
                   (128, 64), (256, 64)]


@pytest.mark.parametrize("s,d", FLASH_BWD_CASES)
def test_flash_backward_tiling_matches_the_plain_backward(s, d):
    """The mirror against ``flash_attention_bwd_reference`` (autograd of the
    plain version in f32) and ``jax.vjp`` of the JAX package's
    ``dot_product_attention`` on bf16-valued inputs: within
    2^-6·max(1, max|plain|) per output, the tolerance ``chip_smoke.py`` holds
    the kernel to (the mirror rounds P and dS to bf16 and takes delta from
    the bf16 output where the plain backward takes it in f32 from P); and
    the residual forward's lse within 1e-3 (natural units) of the plain
    logsumexp. Each gradient is also within 1e-2 of its plain counterpart
    in relative L2."""
    q, k, v, do, scale = _bwd_case(s, d)
    got = flash_bwd_tiled(q, k, v, do, scale)
    ref = p_attn.flash_attention_bwd_reference(*(t[None, :, None] for t in (q, k, v, do)),
                                               scale)
    _, vjp = jax.vjp(lambda *a: j_dpa(*a, scale=scale),
                     *(jnp.asarray(t[None, :, None].numpy()) for t in (q, k, v)))
    j_ref = vjp(jnp.asarray(do[None, :, None].numpy()))
    for g, r, jr in zip(got, ref, j_ref):
        for plain in (r[0, :, 0], torch.from_numpy(np.array(jr)[0, :, 0])):
            assert _bwd_within(g, plain) == (True, True)
    lse = flash_fwd_residual(q, k, v, scale)[1]
    plain_lse = torch.logsumexp((q @ k.T) * scale, dim=-1)
    assert float((lse / LOG2E - plain_lse).abs().max()) <= 1e-3


@pytest.mark.parametrize("s,d", FLASH_BWD_CASES + [(1024, 40), (1024, 512)])
def test_flash_backward_checks_catch_a_missing_delta(s, d):
    """The mirror with delta planted at 0 fails both of the kernel's checks
    on dq and dk (dv takes no delta) at every case above and at a train
    step's 1024 rows: the delta term is small beside dp, and the checks
    still see it."""
    q, k, v, do, scale = _bwd_case(s, d)
    bad = flash_bwd_tiled(q, k, v, do, scale, plant_zero_delta=True)
    ref = p_attn.flash_attention_bwd_reference(*(t[None, :, None] for t in (q, k, v, do)),
                                               scale)
    for g, r in zip(bad[:2], ref[:2]):
        assert _bwd_within(g, r[0, :, 0]) == (False, False)
    assert _bwd_within(bad[2], ref[2][0, :, 0]) == (True, True)


def test_swizzled_stream_maps_are_the_identity():
    """At D = 64 the loads' swizzled stores and the descriptors' reads agree:
    every K-major and MN-major operand position reads its own element; a
    store without the swizzle does not."""
    ident = torch.arange(64 * 64).reshape(64, 64)
    for got in swizzled_stream_maps():
        assert torch.equal(got, ident)
    for got in swizzled_stream_maps(ignore_swizzle=True):
        assert not torch.equal(got, ident)


@pytest.mark.parametrize("s", [128, 256])
def test_flash_backward_checks_catch_an_unswizzled_load(s):
    """The D = 64 mirror whose loads store without the swizzle fails both of
    the kernel's checks on every gradient."""
    q, k, v, do, scale = _bwd_case(s, 64)
    bad = flash_bwd_tiled(q, k, v, do, scale, ignore_swizzle=True)
    ref = p_attn.flash_attention_bwd_reference(*(t[None, :, None] for t in (q, k, v, do)),
                                               scale)
    for g, r in zip(bad, ref):
        assert _bwd_within(g, r[0, :, 0]) == (False, False)


def test_flash_backward_pieces_hooks_fit_the_kernel():
    """``scripts/bwd_pieces.py`` takes the kernel apart by exact text: every
    hook must still match once (it raises otherwise)."""
    from latentsync_tpu_torch.scripts import bwd_pieces

    text = bwd_pieces.hooked_source()
    assert text.count("#if LS_PIECES") == len(bwd_pieces.HOOKS) - 1
