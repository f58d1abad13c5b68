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
full-width UNet.
"""

import pytest
import torch

from latentsync_tpu_torch.ops import attn_block, ffn
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
def test_cuda_tensors_never_take_the_plain_version(rand):
    """An unsupported shape on the card raises; it does not fall back."""
    q = rand(2, 12, 64)  # F = 12: no temporal kernel
    with pytest.raises(ValueError):
        ta.temporal_attention(q, q, q, 8)
    q = rand(2, 64, 320).float()  # the kernels take bf16 only
    with pytest.raises(TypeError):
        ta.spatial_attention(q, q, q, 8)
