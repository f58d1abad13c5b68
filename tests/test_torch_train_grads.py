"""The gradients the rest of stage-2 training needs, against the JAX package.

- The int8 routes' straight-through rules (``ops/qconv.py`` ``QConvSTE``,
  ``QDenseSTE``): the port's ``quantized_conv2d`` (strides 1 and 2, two
  paddings, with and without a bias) and ``dense_with_params`` under
  ``LATENTSYNC_INT8_DENSE=1`` and ``=pallas`` (K8's plain version here; the
  JAX K8 in Pallas interpret mode), forward and the input, weight and bias
  gradients against ``jax.vjp`` of the JAX entries, whose ``custom_vjp``
  backward is the float product's VJP. ``gradcheck`` cannot hold these
  Functions: their backward is not the forward's derivative.
- K5 (``cross_attention_block``) and K9 (``qkv_proj``): the VJP against
  ``jax.vjp`` of the JAX entries in interpret mode (``_cross_bwd``,
  ``_qkv_bwd``), and ``gradcheck`` of both Functions in float64; K9's
  three outputs with one of them unused.

f32; tolerances at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu.ops import qconv as j_qc
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.ops import qconv as p_qc

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

# f32: the two packages sum the float products in other orders; the int8
# forwards quantize the same f32 values to the same codes
ATOL, RTOL = 2e-5, 2e-5


def _t(a, grad=True):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol, rtol=rtol)


def _rand(rng, *shape, s=1.0):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the int8 straight-through rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("stride,pad", [(1, 1), (1, 0), (2, 1), (2, 0)])
def test_quantized_conv2d_is_straight_through_as_jax(monkeypatch, stride, pad, bias):
    monkeypatch.setenv("LATENTSYNC_INT8", "1")
    rng = np.random.default_rng(10 * stride + pad)
    x = _rand(rng, 2, 9, 9, 8)                       # NHWC
    w = _rand(rng, 3, 3, 8, 16, s=(72) ** -0.5)      # HWIO
    b = _rand(rng, 16, s=0.1) if bias else None
    strides, padding = (stride, stride), ((pad, pad), (pad, pad))

    def jf(x, w, *b):
        return j_qc.quantized_conv2d(x, w, b[0] if b else None, strides, padding)

    j_in = [x, w] + ([b] if bias else [])
    ref, vjp = jax.vjp(jf, *map(jnp.asarray, j_in))
    cot = _rand(rng, *ref.shape)
    ref_grads = vjp(jnp.asarray(cot))

    tx, tw = _t(x.transpose(0, 3, 1, 2)), _t(w.transpose(3, 2, 0, 1))
    tb = _t(b) if bias else None
    out = p_qc.quantized_conv2d(tx, tw, tb, (stride, stride), (pad, pad))
    assert type(out.grad_fn).__name__ == "QConvSTEBackward"
    _close(out.detach().numpy().transpose(0, 2, 3, 1), ref)
    out.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2).copy()))
    got = [tx.grad.numpy().transpose(0, 2, 3, 1), tw.grad.numpy().transpose(2, 3, 1, 0)] \
        + ([tb.grad.numpy()] if bias else [])
    for g, r in zip(got, ref_grads):
        _close(g, r)
    # the rule is the float convolution's gradient, which round() alone
    # (gradient 0) would leave to the scales' amax
    assert _rel(got[0], ref_grads[0]) < 1e-5


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", ["1", "pallas"])
def test_dense_with_params_is_straight_through_as_jax(monkeypatch, mode, bias):
    """``=1`` is ``_qdense_ste``; ``=pallas`` is K8's ``_qdense_pallas_ste``
    (the JAX kernel in interpret mode on the CPU, the port's plain version
    of K8 here)."""
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", mode)
    rng = np.random.default_rng(3 if mode == "1" else 4)
    x = _rand(rng, 2, 64, 32)
    w = _rand(rng, 32, 48, s=32**-0.5)               # flax (in, out)
    b = _rand(rng, 48, s=0.1) if bias else None

    def jf(x, w, *b):
        return j_qc.dense_with_params(x, w, b[0] if b else None, jnp.float32)

    j_in = [x, w] + ([b] if bias else [])
    ref, vjp = jax.vjp(jf, *map(jnp.asarray, j_in))
    cot = _rand(rng, *ref.shape)
    ref_grads = vjp(jnp.asarray(cot))

    tx, tw = _t(x), _t(w.T)
    tb = _t(b) if bias else None
    out = p_qc.dense_with_params(tx, tw, tb, torch.float32)
    _close(out.detach().numpy(), ref)
    out.backward(torch.from_numpy(cot))
    got = [tx.grad.numpy(), tw.grad.numpy().T] + ([tb.grad.numpy()] if bias else [])
    for g, r in zip(got, ref_grads):
        _close(g, r)


@pytest.mark.parametrize("route", ["conv", "dense", "pallas"])
def test_straight_through_saves_only_x_w_and_bias(monkeypatch, route):
    """As the JAX ``_fwd``s: the residuals are the inputs themselves, and
    the backward rounds each gradient to its input's dtype."""
    rng = np.random.default_rng(5)
    if route == "conv":
        x, w, b = _t(_rand(rng, 2, 4, 6, 6)), _t(_rand(rng, 8, 4, 3, 3)), _t(_rand(rng, 8))
        out = p_qc.quantized_conv2d(x.bfloat16(), w, b, (1, 1), (1, 1))
    else:
        monkeypatch.setenv("LATENTSYNC_INT8_DENSE", "1" if route == "dense" else "pallas")
        x, w, b = _t(_rand(rng, 16, 8)), _t(_rand(rng, 12, 8)), _t(_rand(rng, 12))
        out = p_qc.dense_with_params(x.bfloat16(), w, b, torch.bfloat16)
    node = out.grad_fn
    while type(node).__name__ not in ("QConvSTEBackward", "QDenseSTEBackward"):
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert len(saved) == 3
    assert saved[0].dtype == torch.bfloat16 and saved[1] is not None
    assert torch.equal(saved[1], w.detach()) and torch.equal(saved[2], b.detach())
    out.float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == torch.float32
    assert torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# K5 and K9
# ---------------------------------------------------------------------------


def test_cross_attention_block_vjp_matches_the_jax_custom_vjp():
    rng = np.random.default_rng(6)
    b, s, sk, c, cc, heads = 2, 16, 8, 32, 24, 4
    x, ctx = _rand(rng, b, s, c), _rand(rng, b, sk, cc)
    wq, wo = _rand(rng, c, c, s=c**-0.5), _rand(rng, c, c, s=c**-0.5)
    wk, wv = _rand(rng, cc, c, s=cc**-0.5), _rand(rng, cc, c, s=cc**-0.5)
    bo, ls, lb = _rand(rng, c, s=0.1), 1 + _rand(rng, c, s=0.1), _rand(rng, c, s=0.1)
    cot = _rand(rng, b, s, c)
    assert j_ab._pick_cross_block(b, s, sk, c, cc, c, heads) > 0  # the Pallas kernel runs

    def jf(x, ls, lb, ctx, wq, wk, wv, wo, bo):
        return j_ab.cross_attention_block(x, ls, lb, ctx, wq, wk, wv, wo, bo, heads,
                                          interpret=True)

    j_in = [x, ls, lb, ctx, wq, wk, wv, wo, bo]
    ref, vjp = jax.vjp(jf, *map(jnp.asarray, j_in))
    ref_grads = vjp(jnp.asarray(cot))
    tin = [_t(x), _t(ls), _t(lb), _t(ctx), _t(wq.T), _t(wk.T), _t(wv.T), _t(wo.T), _t(bo)]
    out = p_ab.cross_attention_block(*tin, heads)
    assert type(out.grad_fn).__name__ == "ComposedGradBackward"
    _close(out.detach().numpy(), ref)
    out.backward(torch.from_numpy(cot))
    got = [t.grad.numpy() for t in tin]
    got[4:8] = [g.T for g in got[4:8]]
    for g, r in zip(got, ref_grads):
        _close(g, r, atol=1e-4)


def test_qkv_proj_vjp_matches_the_jax_custom_vjp():
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 64, 32)  # 128 rows: a block the Pallas kernel tiles
    ws = [_rand(rng, 32, 48, s=32**-0.5) for _ in range(3)]
    cots = [_rand(rng, 2, 64, 48) for _ in range(3)]
    assert j_ffn._pick_qkv_bm(128, 32, 48) > 0
    ref, vjp = jax.vjp(lambda x, *w: j_ffn.qkv_proj(x, *w, interpret=True),
                       *map(jnp.asarray, [x] + ws))
    ref_grads = vjp(tuple(map(jnp.asarray, cots)))
    tx, tws = _t(x), [_t(w.T) for w in ws]
    outs = p_ffn.qkv_proj(tx, *tws)
    assert all(type(o.grad_fn).__name__ == "ComposedGradBackward" for o in outs)
    for o, r in zip(outs, ref):
        _close(o.detach().numpy(), r)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    got = [tx.grad.numpy()] + [t.grad.numpy().T for t in tws]
    for g, r in zip(got, ref_grads):
        _close(g, r, atol=1e-4)


def test_qkv_proj_gradient_with_an_unused_output():
    """An output nothing used gets no gradient: the backward differentiates
    the others alone (``set_materialize_grads(False)``), and the weight of
    the unused product gets zero."""
    rng = np.random.default_rng(8)
    x = _t(_rand(rng, 6, 8))
    ws = [_t(_rand(rng, 4, 8)) for _ in range(3)]
    q, k, _ = p_ffn.qkv_proj(x, *ws)
    (q.sum() + 2 * k.sum()).backward()
    ref_x = ws[0].detach().sum(0) + 2 * ws[1].detach().sum(0)
    torch.testing.assert_close(x.grad, ref_x.expand(6, 8), atol=1e-5, rtol=1e-5)
    assert ws[2].grad is None or not ws[2].grad.any()
    torch.testing.assert_close(ws[1].grad, 2 * x.detach().sum(0).expand(4, 8), atol=1e-5,
                               rtol=1e-5)


def _f64(rng, *shape, s=1.0):
    return torch.from_numpy(s * rng.standard_normal(shape)).requires_grad_(True)


def _gradcheck(fn, *inputs):
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-5, rtol=1e-4, fast_mode=True)


def test_gradcheck_cross_attention_block():
    rng = np.random.default_rng(11)
    c, cc = 8, 6
    _gradcheck(lambda *a: p_ab.cross_attention_block(*a, 2), _f64(rng, 2, 4, c),
               1 + _f64(rng, c, s=0.1), _f64(rng, c, s=0.1), _f64(rng, 2, 3, cc),
               _f64(rng, c, c, s=0.3), _f64(rng, c, cc, s=0.3), _f64(rng, c, cc, s=0.3),
               _f64(rng, c, c, s=0.3), _f64(rng, c, s=0.1))


def test_gradcheck_qkv_proj():
    rng = np.random.default_rng(12)
    _gradcheck(p_ffn.qkv_proj, _f64(rng, 2, 3, 8), *(_f64(rng, 6, 8, s=0.3) for _ in range(3)))
