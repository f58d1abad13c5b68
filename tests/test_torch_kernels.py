"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU (the kernels have no CPU mode): they carry
the ``cuda`` marker and skip elsewhere. This file imports no JAX, so it
also runs where only the port is installed:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Inputs are seeded, in bf16; the tolerance is 2^-6 · max(1, max|plain|),
about two bf16 ulps at the output's top binade (the kernels keep f32
where the plain versions round to bf16, and sum in another order).
Shapes are small versions of every mode the serving path uses, with the
head dims (40, 80, 160) and sequence lengths (16, 64, 256, 1024) of the
full-width UNet; the kernels of the fused-kernel configuration (cross
block, GroupNorm) and the VAE's flash attention run at served shapes.
The int8 configurations add K8 (against its plain version, ragged edges
and all-zero rows included) and the int8 convolution route, whose int32
accumulators must equal the plain float64 ones exactly. The kernel probe
adds K9-K12 (fused q/k/v projection, int8-in/int8-out GEGLU, one-shot and
streaming attention) and the flash route's head dims 40 and 80.
"""

import pytest
import torch

from latentsync_tpu_torch.ops import attention, attn_block, ffn, qconv, qmm
from latentsync_tpu_torch.ops import groupnorm as gn
from latentsync_tpu_torch.ops import temporal_attention as ta

TOL_REL = 2.0**-6


@pytest.fixture
def rand():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator().manual_seed(0)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda", torch.bfloat16)

    return r


def _check(got, ref):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL_REL * max(1.0, float(ref.float().abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(384, 320), (200, 640), (64, 1280)])
@pytest.mark.parametrize("with_ln", [True, False])
def test_geglu_ffn_kernel(rand, m, c, with_ln):
    args = (rand(m, c), rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1),
            rand(c, 4 * c, s=(4 * c) ** -0.5), rand(c, s=0.1))
    ln = (1 + rand(c, s=0.1), rand(c, s=0.1)) if with_ln else (None, None)
    before = ffn.geglu_ffn.launches
    _check(ffn.geglu_ffn(*args, *ln, residual=with_ln),
           ffn.geglu_ffn_reference(*args, *ln, residual=with_ln))
    assert ffn.geglu_ffn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("temporal,b,s,c", [(True, 96, 16, 320), (True, 24, 16, 640),
                                            (False, 4, 256, 640), (False, 2, 64, 320)])
def test_self_attention_block_kernel(rand, temporal, b, s, c):
    assert attn_block.fused_route(s, c, c, temporal)
    args = (rand(b, s, c), 1 + rand(c, s=0.1), rand(c, s=0.1),
            *[rand(c, c, s=c**-0.5) for _ in range(4)], rand(c, s=0.1), 8)
    pe = rand(s, c) if temporal else None
    before = attn_block.self_attention_block.launches
    _check(attn_block.self_attention_block(*args, temporal=temporal, pe=pe),
           attn_block.self_attention_block_reference(*args, temporal=temporal, pe=pe))
    assert attn_block.self_attention_block.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,hd", [(40, 1280), (64, 320), (8, 640)])
def test_temporal_attention_kernel(rand, b, hd):
    q, k, v = rand(b, 16, hd), rand(b, 16, hd), rand(b, 16, hd)
    _check(ta.temporal_attention(q, k, v, 8), ta.temporal_attention_reference(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hd", [(2, 1024, 320), (3, 256, 640), (4, 64, 1280),
                                    (4, 16, 1280), (2, 100, 320)])
def test_spatial_attention_kernel(rand, b, s, hd):
    q, k, v = rand(b, s, hd), rand(b, s, hd), rand(b, s, hd)
    _check(ta.spatial_attention(q, k, v, 8), ta.spatial_attention_reference(q, k, v, 8))


@pytest.mark.cuda
def test_kernels_read_column_slices_of_a_fused_projection(rand):
    """The cores take q/k/v as column views of one (rows, 3·inner) buffer."""
    qkv = rand(32, 16, 3 * 1280)
    q, k, v = qkv[..., :1280], qkv[..., 1280:2560], qkv[..., 2560:]
    _check(ta.temporal_attention(q, k, v, 8), ta.temporal_attention_reference(q, k, v, 8))
    _check(ta.spatial_attention(q, k, v, 8), ta.spatial_attention_reference(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 64])  # VAE decode and encode batches
def test_flash_attention_kernel(rand, b):
    q, k, v = rand(b, 1024, 1, 512), rand(b, 1024, 1, 512), rand(b, 1024, 1, 512)
    before = attention.dot_product_attention.launches
    _check(attention.dot_product_attention(q, k, v),
           attention.dot_product_attention_reference(q, k, v))
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
def test_plain_attention_cores_launch_no_flash_kernel(rand):
    """At S = 1024 the plain spatial core's (B, S, heads, D) attention meets
    the flash route; it must stay plain, or a kernel check would hold one
    kernel against another."""
    q, k, v = rand(2, 1024, 320), rand(2, 1024, 320), rand(2, 1024, 320)
    before = attention.dot_product_attention.launches
    ta.spatial_attention_reference(q, k, v, 8)
    ta.temporal_attention_reference(rand(4, 16, 320), rand(4, 16, 320), rand(4, 16, 320), 8)
    torch.cuda.synchronize()
    assert attention.dot_product_attention.launches == before


def _cross_args(rand, b, s, c):
    return (rand(b, s, c), 1 + rand(c, s=0.1), rand(c, s=0.1), rand(b, 50, 384),
            rand(c, c, s=c**-0.5), rand(c, 384, s=384**-0.5), rand(c, 384, s=384**-0.5),
            rand(c, c, s=c**-0.5), rand(c, s=0.1), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(64, 1024, 320), (64, 256, 640)])
def test_cross_attention_block_kernel(rand, monkeypatch, b, s, c):
    args = _cross_args(rand, b, s, c)
    before = attn_block.cross_attention_block.launches
    monkeypatch.delenv("LATENTSYNC_FUSED_XATTN", raising=False)
    attn_block.cross_attention_block(*args)  # switch off: the composed torch
    assert attn_block.cross_attention_block.launches == before
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")
    _check(attn_block.cross_attention_block(*args),
           attn_block.cross_attention_block_reference(*args))
    assert attn_block.cross_attention_block.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("fn,shape,eps,silu", [
    # served shapes, the kernel the reference's routing gives them
    (gn.group_norm_silu, (64, 320, 32, 32), 1e-6, False),
    (gn.group_norm_silu, (4, 1280, 16, 4, 4), 1e-5, True),
    (gn.group_norm_silu_streaming, (4, 960, 16, 32, 32), 1e-5, True),
    (gn.group_norm_silu_streaming, (4, 2560, 16, 4, 4), 1e-5, True),
    # shapes each kernel does not normally get: a large slab in K6, a
    # small one in K7, and a spatial size that is no multiple of 8
    (gn.group_norm_silu, (4, 320, 16, 32, 32), 1e-5, True),
    (gn.group_norm_silu_streaming, (64, 320, 32, 32), 1e-6, False),
    (gn.group_norm_silu, (3, 64, 5, 7), 1e-5, True),
    (gn.group_norm_silu_streaming, (3, 64, 5, 7), 1e-5, False),
])
def test_group_norm_kernels(rand, fn, shape, eps, silu):
    c = shape[1]
    args = (rand(*shape) * 2 + 0.5, 1 + rand(c, s=0.1), rand(c, s=0.1), 32)
    before = fn.launches
    _check(fn(*args, eps=eps, silu=silu),
           gn.group_norm_silu_reference(*args, eps=eps, silu=silu))
    assert fn.launches == before + 1


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(rand, monkeypatch):
    """An unsupported shape on the card raises; it does not fall back."""
    q = rand(2, 12, 64)  # F = 12: no temporal kernel
    with pytest.raises(ValueError):
        ta.temporal_attention(q, q, q, 8)
    q = rand(2, 64, 320).float()  # the kernels take bf16 only
    with pytest.raises(TypeError):
        ta.spatial_attention(q, q, q, 8)
    q = rand(2, 256, 8, 24)  # on the flash route, but no flash kernel for D = 24
    with pytest.raises(ValueError, match="head dims"):
        attention.dot_product_attention(q, q, q)
    with pytest.raises(TypeError):
        gn.group_norm_silu(rand(2, 64, 8, 8).float(), rand(64), rand(64), 32)
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")
    args = list(_cross_args(rand, 2, 64, 320))
    args[-1] = 16  # d = 20: on the kernel's route, but the kernel has no d = 20
    with pytest.raises(ValueError):
        attn_block.cross_attention_block(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 24, 136), (3200, 384, 320), (1024, 1280, 1280),
                                   (2048, 320, 2560), (512, 5120, 1280), (17, 640, 5120)])
@pytest.mark.parametrize("bias", [True, False])
def test_quantized_matmul_kernel(rand, m, k, n, bias):
    x = rand(m, k)
    x[::7] = 0  # the CFG pass's all-zero audio context: exactly the bias
    w, b = rand(n, k, s=k**-0.5), rand(n, s=0.1) if bias else None
    before = qmm.quantized_matmul.launches
    got = qmm.quantized_matmul(x, w, b)
    _check(got, qmm.quantized_matmul_reference(x, w, b))
    assert qmm.quantized_matmul.launches == before + 1
    want = torch.zeros(n, device="cuda", dtype=torch.bfloat16) if b is None else b
    assert torch.equal(got[::7], want.expand_as(got[::7]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,ksize,stride,pad", [
    ((64, 13, 32, 32), 320, 3, 1, 1),    # UNet conv_in: K = 117, padded to 120
    ((64, 320, 32, 32), 320, 3, 1, 1),
    ((64, 960, 16, 16), 640, 1, 1, 0),   # a 1×1 shortcut
    ((64, 640, 17, 17), 640, 3, 2, 0),   # stride 2 after the (0, 1) pad
    ((4, 128, 256, 256), 3, 3, 1, 1),    # VAE decoder conv_out: N = 3, padded to 8
    ((4, 1280, 4, 4), 1280, 3, 1, 1),    # M = 64
])
def test_int8_conv_route_accumulates_exactly(rand, shape, cout, ksize, stride, pad):
    gen = torch.Generator(device="cuda").manual_seed(1)
    xq = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, shape[1], ksize, ksize), generator=gen, device="cuda",
                       dtype=torch.int8)
    before = qconv.conv_acc.launches
    acc = qconv.conv_acc(xq, wq, (stride, stride), (pad, pad))
    assert qconv.conv_acc.launches == before + 1
    assert torch.equal(acc, qconv.conv_acc_reference(xq, wq, (stride, stride), (pad, pad)))


@pytest.mark.cuda
def test_quantized_conv2d_frame_chunks_equal_the_plain_route(rand, monkeypatch):
    x, w, b = rand(12, 64, 32, 32), rand(128, 64, 3, 3, s=0.05), rand(128, s=0.1)
    monkeypatch.setattr(qconv, "_CHUNK_BYTES", 5 * 32 * 32 * (64 * 9 + 4 * 128))
    assert qconv.chunk_frames(32, 32, 64 * 9, 128) == 5
    before = qconv.conv_acc.launches
    got = qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1))
    assert qconv.conv_acc.launches == before + 3  # 5 + 5 + 2 frames
    monkeypatch.setattr(qconv, "conv_acc", qconv.conv_acc_reference)
    assert torch.equal(got, qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1)))


@pytest.mark.cuda
def test_int8_dense_xla_mode_on_the_card(rand, monkeypatch):
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", "1")
    x, w, b = rand(3, 100, 320), rand(640, 320, s=320**-0.5), rand(640, s=0.1)
    got = qconv.dense_with_params(x, w, b, torch.bfloat16)
    _check(got.cpu(), qconv.dense_with_params(x.cpu(), w.cpu(), b.cpu(), torch.bfloat16))


@pytest.mark.cuda
def test_int8_dense_pallas_mode_launches_k8_or_raises(rand, monkeypatch):
    monkeypatch.setenv("LATENTSYNC_INT8_DENSE", "pallas")
    x, w = rand(64, 320), rand(320, 320, s=320**-0.5)
    before = qmm.quantized_matmul.launches
    qconv.dense_with_params(x, w, None, torch.bfloat16)
    assert qmm.quantized_matmul.launches == before + 1
    with pytest.raises(TypeError):  # the kernel takes bf16 only
        qconv.dense_with_params(x.float(), w, None, torch.float32)
    with pytest.raises(ValueError):  # K = 20: no kernel
        qconv.dense_with_params(rand(64, 20), rand(32, 20), None, torch.bfloat16)
    assert qmm.quantized_matmul.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 256, 8, 40), (2, 256, 8, 80), (8, 1024, 8, 40),
                                     (8, 256, 8, 80), (3, 384, 2, 40)])
def test_flash_route_head_dims_of_the_probe(rand, b, s, h, d):
    q, k, v = rand(b, s, h, d), rand(b, s, h, d), rand(b, s, h, d)
    before = attention.dot_product_attention.launches
    _check(attention.dot_product_attention(q, k, v),
           attention.dot_product_attention_reference(q, k, v))
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("lead,c,inner", [((256,), 64, 64), ((4, 100), 320, 320),
                                          ((1000,), 640, 640), ((130,), 1280, 1280),
                                          ((77,), 320, 200), ((8192,), 320, 320)])
def test_qkv_proj_kernel(rand, lead, c, inner):
    """K9, ragged M and a ragged column block (inner = 200) included."""
    x = rand(*lead, c)
    ws = [rand(inner, c, s=c**-0.5) for _ in range(3)]
    before = ffn.qkv_proj.launches
    got = ffn.qkv_proj(x, *ws)
    assert ffn.qkv_proj.launches == before + 1
    for g, r in zip(got, ffn.qkv_proj_reference(x, *ws)):
        assert g.shape == (*lead, inner)
        _check(g, r)


def _i8_args(rand, m, c):
    x = rand(m, c)
    return (*ffn.quantize_rowwise(x), rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1).float(),
            rand(c, 4 * c, s=(4 * c) ** -0.5), rand(c, s=0.1).float())


def check_int8io(got, ref):
    """K10 against its plain version: scales within 2^-6 relative, codes
    within 1 (the exact-erf GELU's bf16 ulp, or another summation order,
    can move a code across a rounding boundary), and the dequantized
    output within TOL_REL · max(1, max|plain|) plus one output quantum."""
    torch.cuda.synchronize()
    (gi, gs), (ri, rs) = got, ref
    assert gi.dtype == torch.int8 and gs.dtype == torch.float32
    assert gi.shape == ri.shape and gs.shape == rs.shape == (gi.shape[0], 1)
    assert bool(torch.isfinite(gs).all())
    assert float(((gs - rs).abs() / rs).max()) <= TOL_REL
    assert int((gi.int() - ri.int()).abs().max()) <= 1
    plain = ri.float() * rs
    err = (gi.float() * gs - plain).abs()
    tol = TOL_REL * max(1.0, float(plain.abs().max())) + rs
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(256, 128), (1000, 320), (130, 640), (4096, 320)])
def test_geglu_ffn_int8io_kernel(rand, m, c):
    """K10, ragged M included; its int8 output is a usable next input."""
    args = _i8_args(rand, m, c)
    before = ffn.geglu_ffn_int8io.launches
    got = ffn.geglu_ffn_int8io(*args)
    assert ffn.geglu_ffn_int8io.launches == before + 1
    check_int8io(got, ffn.geglu_ffn_int8io_reference(*args))
    again = ffn.geglu_ffn_int8io(*got, *args[2:])
    check_int8io(again, ffn.geglu_ffn_int8io_reference(*got, *args[2:]))


@pytest.mark.cuda
def test_geglu_ffn_int8io_all_zero_rows(rand):
    """A zero row with zero biases gives scale 1e-12 and zero codes; with the
    biases it gives the same codes as any other zero row."""
    xi, xs, w_up, b_up, w_dn, b_dn = _i8_args(rand, 300, 320)
    xi[::7] = 0
    oi, os_ = ffn.geglu_ffn_int8io(xi, xs, w_up, torch.zeros_like(b_up), w_dn,
                                   torch.zeros_like(b_dn))
    torch.cuda.synchronize()
    assert not bool(oi[::7].any()) and bool((os_[::7] == 1e-12).all())
    got = ffn.geglu_ffn_int8io(xi, xs, w_up, b_up, w_dn, b_dn)
    check_int8io(got, ffn.geglu_ffn_int8io_reference(xi, xs, w_up, b_up, w_dn, b_dn))
    assert torch.equal(got[0][::7], got[0][:1].expand_as(got[0][::7]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d", [(4, 128, 40), (3, 64, 80), (16, 256, 80), (16, 1024, 40),
                                   (2, 768, 80), (1024, 256, 80)])
def test_oneshot_attention_kernel(rand, b, s, d):
    q, k, v = rand(b, s, d), rand(b, s, d), rand(b, s, d)
    before = attention.oneshot_attention.launches
    _check(attention.oneshot_attention(q, k, v), attention.oneshot_attention_reference(q, k, v))
    assert attention.oneshot_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,d", [(2, 256, 256, 128), (3, 256, 512, 128), (4, 1024, 1024, 512),
                                       (64, 1024, 1024, 128)])
def test_flash_kernel(rand, b, sq, sk, d):
    """K12, self- and cross-shaped; held to its own unrounded plain version."""
    q, k, v = rand(b, sq, d), rand(b, sk, d), rand(b, sk, d)
    before = attention.flash_attention.launches
    _check(attention.flash_attention(q, k, v), attention.flash_attention_reference(q, k, v))
    assert attention.flash_attention.launches == before + 1


@pytest.mark.cuda
def test_flash_kernel_is_within_one_output_ulp_of_f64(rand):
    """K12 rounds nothing but its bf16 output: against an f64 attention every
    element is within one bf16 ulp (2^-8 relative) plus 1e-5 for the f32
    sums where the output cancels to near zero."""
    q, k, v = rand(4, 512, 128), rand(4, 512, 128), rand(4, 512, 128)
    exact = torch.softmax(q.double() @ k.double().transpose(1, 2) / 128**0.5, -1) @ v.double()
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert bool(((got.double() - exact).abs() <= 2.0**-8 * exact.abs() + 1e-5).all())


@pytest.mark.cuda
def test_probe_kernels_raise_on_what_they_do_not_take(rand):
    q = rand(4, 100, 40)  # S = 100: no multiple of 64
    with pytest.raises(ValueError):
        attention.oneshot_attention(q, q, q)
    q = rand(4, 128, 48)  # no instantiation for D = 48
    with pytest.raises(ValueError, match="head dims"):
        attention.oneshot_attention(q, q, q)
    q = rand(2, 256, 80)  # the reference's composed lowering: no kernel
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)
    q = rand(2, 128, 128)  # S = 128 does not tile blocks of 256
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        ffn.qkv_proj(rand(64, 320).float(), *[rand(320, 320) for _ in range(3)])
    with pytest.raises(ValueError):  # C = 20 is no multiple of 8
        ffn.qkv_proj(rand(64, 20), *[rand(24, 20) for _ in range(3)])
    with pytest.raises(TypeError):  # codes must be int8
        ffn.geglu_ffn_int8io(rand(64, 320), torch.ones(64, 1, device="cuda"),
                             *_i8_args(rand, 64, 320)[2:])


@pytest.mark.cuda
def test_plain_versions_of_the_probe_kernels_launch_nothing(rand):
    fns = [ffn.qkv_proj, ffn.geglu_ffn_int8io, attention.oneshot_attention,
           attention.flash_attention, attention.dot_product_attention, ffn.geglu_ffn]
    before = [f.launches for f in fns]
    x = rand(256, 320)
    ffn.qkv_proj_reference(x, *[rand(320, 320) for _ in range(3)])
    ffn.geglu_ffn_int8io_reference(*_i8_args(rand, 256, 320))
    q = rand(4, 256, 128)
    attention.oneshot_attention_reference(q, q, q)
    attention.flash_attention_reference(q, q, q)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == before
