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
"""

import pytest
import torch

from latentsync_tpu_torch.ops import attention, attn_block, ffn
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
