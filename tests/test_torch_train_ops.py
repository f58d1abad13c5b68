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
and a torch mirror of ``csrc/flash_attention_bwd.cu``'s tiling (32-row
query tiles, 32- and 16-key tiles, eight partial row statistics a row
merged at the end, bf16 probabilities and dS) agrees with the plain
backward. f32 throughout, tolerances stated at each check.
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


@pytest.mark.parametrize("shape", [(2, 256, 1, 16), (1, 384, 2, 8)])
def test_flash_route_vjp_matches_jax(shape):
    """S >= 256, a multiple of 128: the route of the VAE mid-block (and of
    K4's composed gradient at S = 1024)."""
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
    """The int8 convolution and int8 dense routes launch no kernel of their
    own but would cut autograd the same way; both refuse on a CUDA tensor."""
    from latentsync_tpu_torch.ops import qconv

    for fn in (qconv.quantized_conv2d, qconv._qdense_xla):
        src = ast.unparse(next(n for n in ast.walk(ast.parse(
            pathlib.Path(qconv.__file__).read_text()))
            if isinstance(n, ast.FunctionDef) and n.name == fn.__name__))
        assert "_build.refuse_grad" in src, fn.__name__


# ---------------------------------------------------------------------------
# a mirror of csrc/flash_attention_bwd.cu's tiling
# ---------------------------------------------------------------------------


def _bf16(t):
    return t.to(torch.bfloat16).float()


def flash_bwd_tiled(q, k, v, do, scale):
    """(dq, dk, dv) of one head as the kernel computes them: f32 products of
    bf16 inputs; (1) row statistics over 32-key tiles, eight running
    (max, sum, sum of p·dp) a row, each over 4 columns of every tile, merged
    pairwise at the end as the three xor shuffles do; (2) per 16-key block,
    32-row query tiles: P = exp(s - lse) rounded to bf16 for dV, dS =
    P (dp - delta) scale rounded to bf16 for dK; (3) per 32-row query tile,
    32-key tiles: dS rounded to bf16 for dQ. Outputs rounded to bf16."""
    s_len = q.shape[0]
    lse, delta = torch.empty(s_len), torch.empty(s_len)
    for q0 in range(0, s_len, 32):
        qs, os_ = q[q0:q0 + 32], do[q0:q0 + 32]
        m = torch.full((32, 8), -math.inf)
        l, du = torch.zeros(32, 8), torch.zeros(32, 8)
        for k0 in range(0, s_len, 32):
            s = (qs @ k[k0:k0 + 32].T) * scale
            dp = os_ @ v[k0:k0 + 32].T
            for part in range(8):
                for j in range(4):
                    x, y = s[:, part * 4 + j], dp[:, part * 4 + j]
                    mn = torch.maximum(m[:, part], x)
                    corr = torch.exp(m[:, part] - mn)
                    p = torch.exp(x - mn)
                    l[:, part] = l[:, part] * corr + p
                    du[:, part] = du[:, part] * corr + p * y
                    m[:, part] = mn
        for off in (1, 2, 4):
            idx = torch.arange(8) ^ off
            mo, lo, uo = m[:, idx], l[:, idx], du[:, idx]
            mn = torch.maximum(m, mo)
            ca, cb = torch.exp(m - mn), torch.exp(mo - mn)
            l, du, m = l * ca + lo * cb, du * ca + uo * cb, mn
        lse[q0:q0 + 32] = m[:, 0] + torch.log(l[:, 0])
        delta[q0:q0 + 32] = du[:, 0] / l[:, 0]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, s_len, 16):
        for q0 in range(0, s_len, 32):
            s = (q[q0:q0 + 32] @ k[k0:k0 + 16].T) * scale
            dp = do[q0:q0 + 32] @ v[k0:k0 + 16].T
            p = torch.exp(s - lse[q0:q0 + 32, None])
            ds = p * (dp - delta[q0:q0 + 32, None]) * scale
            dv[k0:k0 + 16] += _bf16(p).T @ do[q0:q0 + 32]
            dk[k0:k0 + 16] += _bf16(ds).T @ q[q0:q0 + 32]
    dq = torch.zeros_like(q)
    for q0 in range(0, s_len, 32):
        for k0 in range(0, s_len, 32):
            s = (q[q0:q0 + 32] @ k[k0:k0 + 32].T) * scale
            dp = do[q0:q0 + 32] @ v[k0:k0 + 32].T
            p = torch.exp(s - lse[q0:q0 + 32, None])
            dq[q0:q0 + 32] += _bf16(p * (dp - delta[q0:q0 + 32, None]) * scale) @ k[k0:k0 + 32]
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("s,d", [(64, 40), (128, 80)])
def test_flash_backward_tiling_matches_the_plain_backward(s, d):
    """The mirror against ``flash_attention_bwd_reference`` (autograd of the
    plain version in f32) on bf16-valued inputs: within 2^-6·max(1, max|plain|)
    per output, the tolerance ``chip_smoke.py`` holds the kernel to (the
    mirror rounds P and dS to bf16 where the plain f32 backward does not)."""
    gen = torch.Generator().manual_seed(s + d)
    q, k, v, do = (_bf16(torch.randn(s, d, generator=gen)) for _ in range(4))
    scale = d**-0.5
    got = flash_bwd_tiled(q, k, v, do, scale)
    ref = p_attn.flash_attention_bwd_reference(*(t[None, :, None] for t in (q, k, v, do)),
                                               scale)
    for g, r in zip(got, ref):
        r = r[0, :, 0]
        assert float((g - r).abs().max()) <= 2**-6 * max(1.0, float(r.abs().max()))
