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
accumulators must equal the plain float64 ones exactly.
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
    q = rand(2, 256, 8, 40)  # on the flash route, but no flash kernel for D = 40
    with pytest.raises(ValueError):
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
