"""Gradients through the hand kernels on the card (``cuda`` marker; skipped
where ``torch.cuda.is_available()`` is false). Imports no JAX, so it runs on
the card machine:

    python -m pytest --noconftest tests/test_torch_train_kernels.py -m cuda -q

- the flash route's backward kernels (``csrc/flash_attention_bwd.cu``)
  against their plain version at the head dims of the training path and at
  the three shapes a train step gives them; two calls equal bit for bit; the
  gradients through ``dot_product_attention`` (the residual forward's o and
  lse, saved by the Function) equal to a direct call's; the residual
  forward's lse against the plain logsumexp;
- K1-K5, K9 and the flash route under grad: a ``grad_fn`` on the output,
  and input and weight gradients against the plain version's autograd on
  the same bf16 inputs; the int8 convolution, the int8 dense route and K8
  (straight through): the gradient of the float product, finite, with the
  forward under grad equal bit for bit to the one without;
- every other kernel wrapper (K6, K7, K10-K12) raises under grad.

Tolerance: 2^-6 · max(1, max|plain|) per tensor, as ``chip_smoke.py``'s;
the flash backward's gradients also within 1e-2 in relative L2 each.
"""

import math

import pytest
import torch

from latentsync_tpu_torch.ops import attention, attn_block, ffn, groupnorm, qconv, qmm
from latentsync_tpu_torch.ops import temporal_attention as ta

TOL_REL = 2.0**-6
# the flash backward's relative L2 error a gradient, as chip_smoke.py's
BWD_REL_L2_TOL = 1e-2


@pytest.fixture
def rand():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator().manual_seed(14)

    def r(*shape, s=1.0, add=0.0, grad=True):
        return (torch.randn(shape, generator=gen) * s + add).to("cuda", torch.bfloat16) \
            .requires_grad_(grad)
    return r


def _close(got, ref):
    torch.cuda.synchronize()
    for g, p in zip(got, ref):
        tol = TOL_REL * max(1.0, float(p.float().abs().max()))
        assert torch.isfinite(g).all()
        assert float((g.float() - p.float()).abs().max()) <= tol


# the head dims at batch 2, then the shapes of a train step: the VAE
# decode's mid-block, the UNet's spatial attention at C = 320 and 640, and
# CodeFormer's transformer at batch 4 and 1
TRAIN_FLASH_SHAPES = [(16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80),
                      (4, 256, 8, 64), (1, 256, 8, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 256, 1, 512), (2, 1024, 8, 40), (2, 256, 8, 80),
                                     (2, 384, 2, 64)] + TRAIN_FLASH_SHAPES)
def test_flash_backward_kernel_matches_plain(rand, b, s, h, d):
    q, k, v, do = (rand(b, s, h, d, grad=False) for _ in range(4))
    before = attention.flash_attention_bwd.launches
    got = attention.flash_attention_bwd(q, k, v, do, d**-0.5)
    assert attention.flash_attention_bwd.launches == before + 1
    ref = attention.flash_attention_bwd_reference(q, k, v, do, d**-0.5)
    _close(got, ref)
    for g, p in zip(got, ref):
        assert float((g.float() - p.float()).norm() / p.float().norm()) <= BWD_REL_L2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", TRAIN_FLASH_SHAPES)
def test_flash_backward_is_deterministic(rand, b, s, h, d):
    q, k, v, do = (rand(b, s, h, d, grad=False) for _ in range(4))
    o, lse = attention.flash_attention_fwd(q, k, v, d**-0.5)
    first = attention.flash_attention_bwd(q, k, v, do, d**-0.5, o=o, lse=lse)
    second = attention.flash_attention_bwd(q, k, v, do, d**-0.5, o=o, lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", TRAIN_FLASH_SHAPES)
def test_flash_route_residuals_match_a_direct_call(rand, b, s, h, d):
    """The Function's forward saves o and lse (one residual launch) and its
    backward is the same two launches a direct call makes after its own
    residual forward: equal bits; the output equals the forward without
    grad; lse within 1e-3 (natural units) of the plain logsumexp."""
    q, k, v = (rand(b, s, h, d) for _ in range(3))
    do = rand(b, s, h, d, grad=False)
    before = attention.dot_product_attention.launches
    out = attention.dot_product_attention(q, k, v)
    assert attention.dot_product_attention.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), do)
    with torch.no_grad():
        plain_out = attention.dot_product_attention(q, k, v)
        direct = attention.flash_attention_bwd(q, k, v, do, d**-0.5)
        _, lse = attention.flash_attention_fwd(q, k, v, d**-0.5)
        _, lse_ref = attention.flash_attention_fwd_reference(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), plain_out)
    assert all(torch.equal(x, y) for x, y in zip(got, direct))
    assert float((lse - lse_ref).abs().max()) * math.log(2.0) <= 1e-3


def _grads_against_plain(fn, plain, inputs):
    """Gradients of `fn` (the wrapper) and of `plain` on the same inputs for
    one random output gradient (one a tensor where they return a tuple)."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen).to(o) for o in outs]
    got = torch.autograd.grad(outs, inputs, cots)
    ref = plain(*inputs)
    ref = torch.autograd.grad(ref if isinstance(ref, tuple) else (ref,), inputs, cots)
    _close(got, ref)


@pytest.mark.cuda
def test_geglu_ffn_gradients(rand):
    c = 320
    args = (rand(1024, c), rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1),
            rand(c, 4 * c, s=(4 * c) ** -0.5), rand(c, s=0.1), rand(c, s=0.1, add=1.0),
            rand(c, s=0.1))
    _grads_against_plain(lambda *a: ffn.geglu_ffn(*a, residual=True),
                         lambda *a: ffn.geglu_ffn_reference(*a, residual=True), args)


@pytest.mark.cuda
@pytest.mark.parametrize("temporal,b,s,c", [(True, 1024, 16, 320), (True, 256, 16, 640),
                                            (False, 16, 256, 640)])
def test_self_attention_block_gradients(rand, temporal, b, s, c):
    ws = [rand(c, c, s=c**-0.5) for _ in range(4)]
    args = [rand(b, s, c), rand(c, s=0.1, add=1.0), rand(c, s=0.1), *ws, rand(c, s=0.1),
            rand(s, c)]

    def fn(x, ls, lb, wq, wk, wv, wo, bo, pe):
        return attn_block.self_attention_block(x, ls, lb, wq, wk, wv, wo, bo, 8,
                                               temporal=temporal, pe=pe if temporal else None)

    def plain(x, ls, lb, wq, wk, wv, wo, bo, pe):
        return attn_block.self_attention_block_reference(
            x, ls, lb, wq, wk, wv, wo, bo, 8, temporal=temporal, pe=pe if temporal else None)

    if not temporal:
        args = args[:-1]
        _grads_against_plain(lambda *a: fn(*a, None), lambda *a: plain(*a, None), args)
    else:
        _grads_against_plain(fn, plain, args)


@pytest.mark.cuda
@pytest.mark.parametrize("which,b,s,hd", [("temporal", 64, 16, 1280),
                                          ("spatial", 16, 1024, 320),
                                          ("spatial", 16, 64, 1280)])
def test_attention_core_gradients(rand, which, b, s, hd):
    fn = ta.temporal_attention if which == "temporal" else ta.spatial_attention
    plain = ta.temporal_attention_reference if which == "temporal" \
        else ta.spatial_attention_reference
    _grads_against_plain(lambda q, k, v: fn(q, k, v, 8), lambda q, k, v: plain(q, k, v, 8),
                         [rand(b, s, hd) for _ in range(3)])


@pytest.mark.cuda
def test_flash_route_gradients(rand):
    _grads_against_plain(attention.dot_product_attention,
                         attention.dot_product_attention_reference,
                         [rand(2, 1024, 1, 512) for _ in range(3)])


@pytest.mark.cuda
def test_wrappers_without_a_gradient_raise_under_grad(rand):
    c = 320
    ln = (rand(c), rand(c))
    calls = {
        "group_norm_silu": lambda: groupnorm.group_norm_silu(rand(4, c, 8, 8), *ln, 32),
        "group_norm_silu_streaming": lambda: groupnorm.group_norm_silu_streaming(
            rand(4, c, 16, 32, 32), *ln, 32),
        "geglu_ffn_int8io": lambda: ffn.geglu_ffn_int8io(
            *ffn.quantize_rowwise(rand(256, c, grad=False)), rand(8 * c, c), rand(8 * c),
            rand(c, 4 * c), rand(c)),
        "oneshot_attention": lambda: attention.oneshot_attention(*(rand(8, 256, 40)
                                                                   for _ in range(3))),
        "flash_attention": lambda: attention.flash_attention(*(rand(8, 256, 128)
                                                               for _ in range(3))),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no gradient"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _float_dense(x, w, b):
    return qconv.float_dense(x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["cross_attention_block", "qkv_proj", "quantized_matmul",
                                   "quantized_conv2d", "dense_with_params (int8)"])
def test_wrappers_with_a_gradient_train(rand, monkeypatch, which):
    """K5 and K9 through their composed gradient, K8 and the int8 routes
    straight through: a launch a call under grad (K5, K8, K9), the forward
    under grad equal bit for bit to the one without, and each gradient
    against the plain composition's autograd (for the int8 routes: the
    float product's), finite."""
    c = 320
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")  # K5 launches only so
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", "pallas")
    counter = None
    if which == "cross_attention_block":
        args = [rand(64, 256, c), rand(c, s=0.1, add=1.0), rand(c, s=0.1), rand(64, 50, 384),
                rand(c, c, s=c**-0.5), rand(c, 384, s=384**-0.5), rand(c, 384, s=384**-0.5),
                rand(c, c, s=c**-0.5), rand(c, s=0.1)]
        fn = lambda *a: attn_block.cross_attention_block(*a, 8)  # noqa: E731
        plain = lambda *a: attn_block.cross_attention_block_reference(*a, 8)  # noqa: E731
        counter = attn_block.cross_attention_block
    elif which == "qkv_proj":
        args = [rand(256, c)] + [rand(c, c, s=c**-0.5) for _ in range(3)]
        fn, plain, counter = ffn.qkv_proj, ffn.qkv_proj_reference, ffn.qkv_proj
    elif which == "quantized_matmul":
        args = [rand(1024, c), rand(2560, c, s=c**-0.5), rand(2560, s=0.1)]
        fn = lambda *a: qconv.dense_with_params(*a, torch.bfloat16)  # noqa: E731
        plain, counter = _float_dense, qmm.quantized_matmul
    elif which == "quantized_conv2d":
        args = [rand(2, c, 8, 8), rand(c, c, 3, 3, s=(9 * c) ** -0.5), rand(c, s=0.1)]
        fn = lambda *a: qconv.quantized_conv2d(*a, padding=(1, 1))  # noqa: E731
        plain = lambda *a: qconv.float_conv(*a, (1, 1), (1, 1))  # noqa: E731
    else:
        args = [rand(256, c), rand(c, c, s=c**-0.5), rand(c, s=0.1)]
        fn, plain = qconv._qdense_xla, _float_dense
    before = counter.launches if counter else 0
    out = fn(*args)
    if counter:
        assert counter.launches == before + 1
    with torch.no_grad():
        again = fn(*args)
    for o, a in zip(out if isinstance(out, tuple) else (out,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(o.detach(), a)
    _grads_against_plain(fn, plain, args)
