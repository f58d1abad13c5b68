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
The int8 configurations add K8 (bitwise its plain version at every served
shape, ragged edges, an f32 weight and all-zero rows included) and the int8
convolution route, whose int32 accumulators must equal the plain float64
ones exactly. The kernel probe
adds K9-K12 (fused q/k/v projection, int8-in/int8-out GEGLU, one-shot and
streaming attention) and the flash route's head dims 40 and 80; CodeFormer's
face restoration the flash route at D = 64 (forward only: under grad it
raises); the flash
route and K12 also run at an odd batch, every length class, cross shapes,
large logits and strided views. The
kernels on the GEMM template (K1, K2, K5, K9, K10) also run at widths
that are no multiple of its 64-deep k-tile (72, 200), at M = 1 and 129,
at column counts that are no multiple of a tile, and with every column
tile forced in turn.
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
@pytest.mark.parametrize("b,hd,sliced", [
    (256, 1280, False), (64, 1280, False),  # the default and fused forwards (D = 160)
    (4096, 320, False), (1024, 640, False),  # int8-dense's composed blocks (D = 40, 80)
    (64, 320, True), (16, 640, True)])       # q/k/v pitched in one fused projection
def test_temporal_attention_kernel_served_shapes(rand, b, hd, sliced):
    """K3 at its served shapes: one launch, within the tolerance."""
    if sliced:
        qkv = rand(b, 16, 3 * hd)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    else:
        q, k, v = rand(b, 16, hd), rand(b, 16, hd), rand(b, 16, hd)
    before = ta.temporal_attention.launches
    _check(ta.temporal_attention(q, k, v, 8), ta.temporal_attention_reference(q, k, v, 8))
    assert ta.temporal_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("f", [4, 8, 24])
@pytest.mark.parametrize("b,hd", [(96, 320), (24, 640), (40, 1280)])
def test_temporal_attention_kernel_any_frames(rand, f, b, hd):
    """K3 at F != 16: one m16 row tile with keys past F masked (4, 8), two
    row tiles (24); one launch, within the tolerance."""
    q, k, v = (rand(b, f, hd, s=2.0) for _ in range(3))
    before = ta.temporal_attention.launches
    _check(ta.temporal_attention(q, k, v, 8), ta.temporal_attention_reference(q, k, v, 8))
    assert ta.temporal_attention.launches == before + 1


@pytest.mark.cuda
def test_temporal_attention_kernel_frames_past_the_limit_raise(rand):
    q = rand(4, ta.TEMPORAL_MAX_FRAMES + 1, 320)
    with pytest.raises(ValueError, match="F <= 24"):
        ta.temporal_attention(q, q, q, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [4, 8, 24])
@pytest.mark.parametrize("b,c", [(37, 320), (13, 640)])
def test_self_attention_block_kernel_temporal_any_frames(rand, f, b, c):
    """K2's temporal kernel at F != 16 (sequences padded to 16 or 32 tile
    rows inside the kernel, a batch that leaves the last row tile short),
    through ``self_attention_block_fused``; ``self_attention_block`` routes
    F = 4 to the composed block as the reference does (F < 8), and F = 8, 24
    to the kernel."""
    args = (rand(b, f, c), 1 + rand(c, s=0.1), rand(c, s=0.1),
            *[rand(c, c, s=c**-0.5) for _ in range(4)], rand(c, s=0.1), 8)
    pe = rand(f, c)
    ref = attn_block.self_attention_block_reference(*args, temporal=True, pe=pe)
    before = attn_block.self_attention_block.launches
    _check(attn_block.self_attention_block_fused(*args, temporal=True, pe=pe), ref)
    assert attn_block.self_attention_block.launches == before + 1
    assert attn_block.fused_route(f, c, c, True) == (f >= 8)
    _check(attn_block.self_attention_block(*args, temporal=True, pe=pe), ref)
    assert attn_block.self_attention_block.launches == before + 1 + (f >= 8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,d", [(3, 1, 8), (5, 2, 24), (2, 4, 64), (7, 3, 256)])
def test_temporal_attention_kernel_other_head_dims(rand, b, heads, d):
    """Head dims off the served ones: a single k8 step (8), k16 steps and a
    k8 tail (24), an even count of 8-column tiles (64), a wide head (256)."""
    q, k, v = (rand(b, 16, heads * d, s=2.0) for _ in range(3))
    _check(ta.temporal_attention(q, k, v, heads), ta.temporal_attention_reference(q, k, v, heads))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hd", [(2, 1024, 320), (3, 256, 640), (4, 64, 1280),
                                    (4, 16, 1280), (2, 100, 320)])
def test_spatial_attention_kernel(rand, b, s, hd):
    q, k, v = rand(b, s, hd), rand(b, s, hd), rand(b, s, hd)
    _check(ta.spatial_attention(q, k, v, 8), ta.spatial_attention_reference(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hd", [(1, 1400, 320), (1, 1400, 640), (1, 1400, 1280),
                                    (3, 8, 1280), (5, 1, 320), (2, 130, 640)])
def test_spatial_attention_kernel_any_length(rand, b, s, hd):
    """Lengths that are no multiple of the 64-key tile, down to one token and
    up to S = 1400 at every head dim (no limit from shared memory: K/V
    stream through it)."""
    q, k, v = rand(b, s, hd), rand(b, s, hd), rand(b, s, hd)
    before = ta.spatial_attention.launches
    _check(ta.spatial_attention(q, k, v, 8), ta.spatial_attention_reference(q, k, v, 8))
    assert ta.spatial_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd", [(1024, 320), (256, 640), (100, 320), (64, 1280), (16, 1280)])
def test_spatial_attention_block_q(rand, s, hd):
    """Every query-tile size gives the result of the one picked by shape."""
    q, k, v = rand(2, s, hd), rand(2, s, hd), rand(2, s, hd)
    ref = ta.spatial_attention_reference(q, k, v, 8)
    picked = ta.spatial_attention(q, k, v, 8)
    _check(picked, ref)
    assert torch.equal(picked, ta.spatial_attention(q, k, v, 8,
                                                    block_q=ta.spatial_block_q(s)))
    for block_q in ta.SPATIAL_BLOCK_QS:
        _check(ta.spatial_attention(q, k, v, 8, block_q=block_q), ref)
    with pytest.raises(ValueError, match="block_q"):
        ta.spatial_attention(q, k, v, 8, block_q=32)


def _attention_f64(q, k, v):
    """(B, S, D) attention in float64, nothing rounded."""
    q, k, v = q.double(), k.double(), v.double()
    w = torch.softmax(q @ k.transpose(1, 2) / q.shape[-1] ** 0.5, -1)
    return w @ v


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(1024, 40), (256, 80), (100, 40), (64, 160)])
def test_spatial_attention_large_logits(rand, s, d):
    """Inputs × 30: logits in the thousands, so the running maximum moves by
    large steps, in some tiles and not in others; against an f64 attention."""
    b, heads = 2, 8
    q, k, v = (30 * rand(b, s, heads * d) for _ in range(3))
    got = ta.spatial_attention(q, k, v, heads)

    def fold(t):
        return t.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)

    exact = _attention_f64(fold(q), fold(k), fold(v))
    _check(fold(got), exact.float())


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(1024, 40), (256, 80), (64, 40)])
def test_oneshot_attention_large_logits(rand, s, d):
    q, k, v = (30 * rand(6, s, d) for _ in range(3))
    _check(attention.oneshot_attention(q, k, v), _attention_f64(q, k, v).float())


@pytest.mark.cuda
def test_oneshot_attention_split_batch(rand):
    """No state crosses blocks: B in two calls gives the same bits."""
    q, k, v = rand(48, 512, 40), rand(48, 512, 40), rand(48, 512, 40)
    whole = attention.oneshot_attention(q, k, v)
    parts = torch.cat([attention.oneshot_attention(q[:20], k[:20], v[:20]),
                       attention.oneshot_attention(q[20:], k[20:], v[20:])])
    torch.cuda.synchronize()
    assert torch.equal(whole, parts)


@pytest.mark.cuda
def test_kernels_read_column_slices_of_a_fused_projection(rand):
    """The cores take q/k/v as column views of one (rows, 3·inner) buffer."""
    qkv = rand(32, 16, 3 * 1280)
    q, k, v = qkv[..., :1280], qkv[..., 1280:2560], qkv[..., 2560:]
    _check(ta.temporal_attention(q, k, v, 8), ta.temporal_attention_reference(q, k, v, 8))
    _check(ta.spatial_attention(q, k, v, 8), ta.spatial_attention_reference(q, k, v, 8))
    qkv = rand(64, 256, 3 * 640)  # K2's spatial mode: one (rows, 3·inner) buffer
    q, k, v = qkv[..., :640], qkv[..., 640:1280], qkv[..., 1280:]
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
    q = rand(2, 25, 64)  # F = 25: past the temporal kernel's 24 frames
    with pytest.raises(ValueError):
        ta.temporal_attention(q, q, q, 8)
    q = rand(2, 64, 320).float()  # the kernels take bf16 only
    with pytest.raises(TypeError):
        ta.spatial_attention(q, q, q, 8)
    q = rand(2, 64, 320)
    with pytest.raises(ValueError, match="scale"):  # the kernels fold scale into a base-2 exponent
        ta.spatial_attention(q, q, q, 8, scale=-1.0)
    with pytest.raises(ValueError, match="scale"):
        attention.oneshot_attention(rand(2, 64, 40), rand(2, 64, 40), rand(2, 64, 40), scale=0.0)
    q = rand(2, 256, 8, 24)  # on the flash route, but no flash kernel for D = 24
    with pytest.raises(ValueError, match="head dims"):
        attention.dot_product_attention(q, q, q)
    with pytest.raises(TypeError):
        gn.group_norm_silu(rand(2, 64, 8, 8).float(), rand(64), rand(64), 32)
    with pytest.raises(ValueError, match="no kernel"):  # K7: 65535 slabs at most (the grid's y)
        gn.group_norm_silu_streaming(rand(2049, 32, 1, 8), rand(32), rand(32), 32)
    ws = [rand(72, 72) for _ in range(4)]  # temporal head dim 8: no one-launch kernel
    with pytest.raises(ValueError, match="no kernel"):
        attn_block.self_attention_block(rand(2, 16, 72), rand(72), rand(72), *ws, rand(72), 9,
                                        temporal=True, pe=rand(16, 72))
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")
    args = list(_cross_args(rand, 2, 64, 320))
    args[-1] = 16  # d = 20: on the kernel's route, but the kernel has no d = 20
    with pytest.raises(ValueError):
        attn_block.cross_attention_block(*args)


# (M, K, N) of every K8 launch of one int8-dense forward (chip_smoke.py QMM_SHAPES)
QMM_SHAPES = [(65536, 320, 2560), (65536, 320, 320), (65536, 1280, 320),
              (16384, 640, 640), (16384, 640, 5120), (16384, 2560, 640),
              (4096, 1280, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
              (1024, 1280, 1280), (1024, 1280, 10240), (1024, 5120, 1280),
              (3200, 384, 320), (3200, 384, 640), (3200, 384, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 24, 136), (3200, 384, 320), (1024, 1280, 1280),
                                   (2048, 320, 2560), (512, 5120, 1280), (17, 640, 5120),
                                   (1000, 328, 328), (1, 8, 8)])  # ragged M, N and K
@pytest.mark.parametrize("bias", [True, False])
def test_quantized_matmul_kernel(rand, m, k, n, bias):
    """Bitwise the plain version, an all-zero row exactly the bias."""
    x = rand(m, k)
    x[::7] = 0  # the CFG pass's all-zero audio context: exactly the bias
    w, b = rand(n, k, s=k**-0.5), rand(n, s=0.1) if bias else None
    before = qmm.quantized_matmul.launches
    got = qmm.quantized_matmul(x, w, b)
    ref = qmm.quantized_matmul_reference(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got, ref)
    assert qmm.quantized_matmul.launches == before + 1
    want = torch.zeros(n, device="cuda", dtype=torch.bfloat16) if b is None else b
    assert torch.equal(got[::7], want.expand_as(got[::7]))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quantized_matmul_kernel_is_bitwise_at_served_shapes(rand, m, k, n):
    x = rand(m, k)
    x[::977] = 0
    w, b = rand(n, k, s=k**-0.5), rand(n, s=0.1)
    got = qmm.quantized_matmul(x, w, b)
    assert torch.equal(got, qmm.quantized_matmul_reference(x, w, b))


@pytest.mark.cuda
def test_quantized_matmul_kernel_takes_an_f32_weight_and_large_accumulators(rand):
    """The row pass reads an f32 weight as it is; codes of +-127 along K =
    5120 give |acc| above 2^24, whose f32 rounding matches the plain one."""
    x = torch.ones(256, 5120, device="cuda", dtype=torch.bfloat16)
    x[1::2, ::3] = 0.5
    w = rand(320, 5120).float().sign()
    w[0] = 1
    got = qmm.quantized_matmul(x, w)
    assert torch.equal(got, qmm.quantized_matmul_reference(x, w))
    w = rand(640, 1280, s=0.02).float()
    x = rand(1000, 1280)
    assert torch.equal(qmm.quantized_matmul(x, w), qmm.quantized_matmul_reference(x, w))
    with pytest.raises(ValueError):  # N = 20: no multiple of 8
        qmm.quantized_matmul(x, rand(20, 1280))


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
                                     (8, 256, 8, 80), (3, 384, 2, 40),
                                     # CodeFormer's transformer: 1 and 4 faces, D = 64
                                     (1, 256, 8, 64), (4, 256, 8, 64), (3, 384, 2, 64)])
def test_flash_route_head_dims_of_the_probe(rand, b, s, h, d):
    q, k, v = rand(b, s, h, d), rand(b, s, h, d), rand(b, s, h, d)
    before = attention.dot_product_attention.launches
    _check(attention.dot_product_attention(q, k, v),
           attention.dot_product_attention_reference(q, k, v))
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
def test_flash_route_at_64_refuses_grad(rand):
    """D = 64 has no backward kernel: under grad with an input that requires
    grad the route raises before it launches anything; without grad it runs."""
    q, k, v = rand(2, 256, 8, 64), rand(2, 256, 8, 64), rand(2, 256, 8, 64)
    before = attention.dot_product_attention.launches
    with pytest.raises(ValueError, match="no backward kernel"):
        attention.dot_product_attention(q.requires_grad_(True), k, v)
    assert attention.dot_product_attention.launches == before
    with torch.no_grad():
        attention.dot_product_attention(q, k, v)
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 384, 1024])
@pytest.mark.parametrize("h,d", [(8, 40), (2, 80), (1, 512), (2, 512)])
def test_flash_route_odd_batch_and_lengths(rand, s, h, d):
    """B = 3 and every length class of the route (S % 128 == 0), at each head
    dim; D = 512 also with two heads side by side in a row."""
    q, k, v = rand(3, s, h, d), rand(3, s, h, d), rand(3, s, h, d)
    before = attention.dot_product_attention.launches
    _check(attention.dot_product_attention(q, k, v),
           attention.dot_product_attention_reference(q, k, v))
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("h,d", [(8, 40), (8, 80), (1, 512)])
def test_flash_route_reads_column_slices_and_refuses_other_views(rand, h, d):
    """q/k/v as column slices of one fused (B, S, 3 H D) projection are read
    in place through their row pitch; a view whose batch or head stride the
    kernel cannot express raises, and nothing is copied."""
    b, s, hd = 3, 256, h * d
    qkv = rand(b, s, 3 * hd)
    q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(b, s, h, d) for i in range(3))
    assert not q.is_contiguous() and q.data_ptr() == qkv.data_ptr()
    before = attention.dot_product_attention.launches
    _check(attention.dot_product_attention(q, k, v),
           attention.dot_product_attention_reference(q, k, v))
    assert attention.dot_product_attention.launches == before + 1
    every_other = rand(2 * b, s, h, d)[::2]  # a batch stride of two entries
    with pytest.raises(ValueError, match="strides"):
        attention.dot_product_attention(every_other, k, v)
    with pytest.raises(ValueError, match="strides"):
        attention.dot_product_attention(q, k, rand(b, s, h, 2 * d)[..., ::2])
    if h > 1:
        wide_heads = rand(b, s, h, 2 * d)[..., :d]  # a head stride of 2 D
        with pytest.raises(ValueError, match="strides"):
            attention.dot_product_attention(wide_heads, k, v)
    assert attention.dot_product_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,d", [(1024, 8, 40), (256, 8, 80), (1024, 1, 512), (256, 1, 512)])
def test_flash_route_large_logits(rand, s, h, d):
    """Inputs x 30: the running maximum moves by large steps in some tiles and
    rests in others; against an f64 attention."""
    b = 2
    q, k, v = (30 * rand(b, s, h, d) for _ in range(3))
    got = attention.dot_product_attention(q, k, v)

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    _check(fold(got), _attention_f64(fold(q), fold(k), fold(v)).float())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,d", [(3, 512, 256, 512), (3, 256, 1024, 512), (5, 64, 192, 128),
                                       (2, 1024, 64, 128)])
def test_flash_kernel_cross_shapes(rand, b, sq, sk, d):
    """K12 with query and key lengths apart, longer and shorter, at both
    tilings; blocks of 64 so that lengths that are no multiple of 256 tile."""
    q, k, v = rand(b, sq, d), rand(b, sk, d), rand(b, sk, d)
    _check(attention.flash_attention(q, k, v, block_q=64, block_k=64),
           attention.flash_attention_reference(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(512, 128), (256, 512)])
def test_flash_kernel_large_logits_and_split_batch(rand, s, d):
    """K12 with inputs x 30 against an f64 attention; no state crosses blocks:
    B in two calls gives the same bits."""
    q, k, v = (30 * rand(6, s, d) for _ in range(3))
    whole = attention.flash_attention(q, k, v)
    _check(whole, _attention_f64(q, k, v).float())
    parts = torch.cat([attention.flash_attention(q[:2], k[:2], v[:2]),
                       attention.flash_attention(q[2:], k[2:], v[2:])])
    torch.cuda.synchronize()
    assert torch.equal(whole, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 1024, 1, 512), (64, 1024, 8, 40), (48, 1024, 512),
                                   (256, 1024, 128)])
def test_flash_kernels_give_the_same_bits_every_launch(rand, shape):
    """More blocks than the card holds at once, launched twenty times on the
    same inputs: a tile overwritten in the ring before its last reader was
    done would show as a launch that differs."""
    q, k, v = rand(*shape), rand(*shape), rand(*shape)
    fn = attention.dot_product_attention if len(shape) == 4 else attention.flash_attention
    first = fn(q, k, v)
    for _ in range(20):
        again = fn(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_flash_kernel_is_within_one_output_ulp_of_f64_at_512(rand):
    """The one-ulp bound of K12 on the column-split tiling (D = 512)."""
    q, k, v = rand(2, 512, 512), rand(2, 512, 512), rand(2, 512, 512)
    exact = torch.softmax(q.double() @ k.double().transpose(1, 2) / 512**0.5, -1) @ v.double()
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert bool(((got.double() - exact).abs() <= 2.0**-8 * exact.abs() + 1e-5).all())


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


# ---------------------------------------------------------------------------
# the GEMM template (csrc/gemm.cuh) at ragged shapes. The host picks the
# column tile from the shape (pick_bn): 160 columns where N is a multiple of
# 160 and 128-row panels x column tiles x operands reach 132 blocks, else 64.
# The shapes marked "wide" below are the smallest ragged ones that take 160.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1, 72), (129, 72), (200, 72), (129, 200), (1, 320), (129, 64),
                                 (8321, 320),    # wide down-projection, last panel of one row
                                 (16769, 160)])  # wide, and K = 160 ends in a short k-tile
@pytest.mark.parametrize("with_ln", [True, False])
def test_geglu_ffn_kernel_ragged(rand, m, c, with_ln):
    """K1 where K is no multiple of the 64-deep k-tile (zero-filled last
    tile), M = 1 and 129, and N = 4C or C no multiple of a column tile."""
    args = (rand(m, c), rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1),
            rand(c, 4 * c, s=(4 * c) ** -0.5), rand(c, s=0.1))
    ln = (1 + rand(c, s=0.1), rand(c, s=0.1)) if with_ln else (None, None)
    _check(ffn.geglu_ffn(*args, *ln, residual=True),
           ffn.geglu_ffn_reference(*args, *ln, residual=True))


@pytest.mark.cuda
def test_geglu_ffn_residual_aliases_no_output(rand):
    """The residual is read from x while the output is written elsewhere: x
    is unchanged, and a second call on the same x gives the same bits."""
    c = 320
    x = rand(300, c)
    keep = x.clone()
    args = (rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1), rand(c, 4 * c, s=(4 * c) ** -0.5),
            rand(c, s=0.1), 1 + rand(c, s=0.1), rand(c, s=0.1))
    out = ffn.geglu_ffn(x, *args, residual=True)
    again = ffn.geglu_ffn(x, *args, residual=True)
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr() and torch.equal(x, keep) and torch.equal(out, again)
    no_res = ffn.geglu_ffn(x, *args, residual=False)
    _check(no_res, ffn.geglu_ffn_reference(x, *args, residual=False))
    assert not torch.equal(no_res, out)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,inner", [(1, 72, 72), (129, 200, 72), (200, 72, 200),
                                       (129, 64, 136), (1000, 320, 960),
                                       (2689, 200, 320),   # wide, short last k-tile
                                       (5505, 72, 160)])   # wide, one column tile an operand
def test_qkv_proj_kernel_ragged(rand, m, c, inner):
    """K9 with inner != C: each of the three outputs against its own product."""
    x = rand(m, c)
    ws = [rand(inner, c, s=c**-0.5) for _ in range(3)]
    refs = ffn.qkv_proj_reference(x, *ws)
    got = ffn.qkv_proj(x, *ws)
    assert len(got) == 3
    for g, r in zip(got, refs):
        assert g.shape == (m, inner)
        _check(g, r)
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1000, 320), (129, 200), (2048, 1280)])
def test_qkv_proj_large_inputs_against_f64(rand, m, c):
    """Inputs x 30 against a float64 product: f32 accumulation over the whole
    K and one rounding to bf16."""
    x = 30 * rand(m, c)
    ws = [30 * rand(c, c, s=c**-0.5) for _ in range(3)]
    for g, w in zip(ffn.qkv_proj(x, *ws), ws):
        _check(g, (x.double() @ w.double().t()).float())


@pytest.mark.cuda
@pytest.mark.parametrize("temporal,b,s,c,heads", [(True, 13, 16, 120, 3), (True, 8, 16, 200, 5),
                                                  (False, 3, 43, 200, 5), (False, 1, 1, 40, 1),
                                                  (False, 1, 129, 80, 2),
                                                  # wide q/k/v and output projections,
                                                  # M = 16784, K = 160 (short last k-tile)
                                                  (True, 1049, 16, 160, 4)])
def test_self_attention_block_kernel_ragged(rand, temporal, b, s, c, heads):
    """K2's products at K = 120, 200, 40, 80 and 160, M = 1, 129, 208 and
    16784 (temporal: row tiles of 128 with a partial last one)."""
    assert attn_block.fused_route(s, c, c, temporal)
    args = (rand(b, s, c), 1 + rand(c, s=0.1), rand(c, s=0.1),
            *[rand(c, c, s=c**-0.5) for _ in range(4)], rand(c, s=0.1), heads)
    pe = rand(s, c) if temporal else None
    _check(attn_block.self_attention_block(*args, temporal=temporal, pe=pe),
           attn_block.self_attention_block_reference(*args, temporal=temporal, pe=pe))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,cc,heads", [(2, 65, 200, 72, 5), (1, 129, 80, 384, 2),
                                            (3, 16, 320, 200, 8),
                                            (9, 1024, 320, 200, 8),  # wide q and output
                                            (3, 100, 320, 384, 8), (3, 300, 640, 384, 8)])
def test_cross_attention_block_kernel_ragged(rand, monkeypatch, b, s, c, cc, heads):
    """K5's three projections at widths and context widths off the k-tile;
    its core at query lengths that end in a partial block of 64 or 128 rows
    (d = 40 and 80)."""
    monkeypatch.setenv("LATENTSYNC_FUSED_XATTN", "1")
    assert attn_block.cross_fused_route(b, s, 50, c, cc, c)
    args = (rand(b, s, c), 1 + rand(c, s=0.1), rand(c, s=0.1), rand(b, 50, cc),
            rand(c, c, s=c**-0.5), rand(c, cc, s=cc**-0.5), rand(c, cc, s=cc**-0.5),
            rand(c, c, s=c**-0.5), rand(c, s=0.1), heads)
    ref = attn_block.cross_attention_block_reference(*args)
    before = attn_block.cross_attention_block.launches
    _check(attn_block.cross_attention_block(*args), ref)
    assert attn_block.cross_attention_block.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1, 72), (129, 200), (200, 72), (129, 64),
                                 (8321, 320)])  # wide f32 down-projection
def test_geglu_ffn_int8io_kernel_ragged(rand, m, c):
    """K10 where K ends in a short k-tile (72, 200) and where it does not
    (64, 320)."""
    args = _i8_args(rand, m, c)
    check_int8io(ffn.geglu_ffn_int8io(*args), ffn.geglu_ffn_int8io_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(300, 400), (77, 328), (64, 640)])
def test_geglu_ffn_int8io_kernel_column_split(rand, m, c):
    """K10 above C = 320, where two warpgroups split the output columns and
    merge their row amax: a ragged last piece (400, 328) and the widest C."""
    args = _i8_args(rand, m, c)
    check_int8io(ffn.geglu_ffn_int8io(*args), ffn.geglu_ffn_int8io_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(8192, 1280), (129, 1280), (200, 1000)])
def test_geglu_ffn_int8io_kernel_wide(rand, m, c):
    """K10 above C = 640: column groups across blocks, the f32 result in a
    scratch buffer, the row pass merging the groups' amax (the probe's
    (8192, 1280), a row past a row block, a ragged last group)."""
    args = _i8_args(rand, m, c)
    before = ffn.geglu_ffn_int8io.launches
    got = ffn.geglu_ffn_int8io(*args)
    assert ffn.geglu_ffn_int8io.launches == before + 1
    check_int8io(got, ffn.geglu_ffn_int8io_reference(*args))


@pytest.mark.cuda
def test_geglu_ffn_int8io_allocates_only_its_outputs(rand):
    """K10 up to C = 640 is one launch with no scratch buffer: the call's
    peak allocation is its two outputs; C past the kernel's widest is
    refused."""
    args = _i8_args(rand, 4096, 320)
    ffn.geglu_ffn_int8io(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ffn.geglu_ffn_int8io(*args)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in out)
    assert torch.cuda.max_memory_allocated() - base <= outputs + 2 * 512  # allocator rounding
    with pytest.raises(ValueError):
        ffn.geglu_ffn_int8io(*_i8_args(rand, 64, ffn.GEGLU_I8_MAX_C + 8))


# a step outside the CFG interval: window batch 2 and no CFG batch, 16
# frames, 32² latents (K1's rows, K2's sequences, K3's and K4's batches)
@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("K1", (32768, 320)), ("K1", (8192, 640)), ("K1", (2048, 1280)), ("K1", (512, 1280)),
    ("K2 temporal", (2048, 16, 320)), ("K2 temporal", (512, 16, 640)),
    ("K2 spatial", (32, 256, 640)),
    ("K3", (128, 16, 1280)), ("K3", (32, 16, 1280)),
    ("K4", (32, 1024, 320)), ("K4", (32, 64, 1280)), ("K4", (32, 16, 1280)),
])
def test_kernels_at_the_half_batch_shapes(rand, kind, shape):
    if kind == "K1":
        m, c = shape
        args = (rand(m, c), rand(8 * c, c, s=c**-0.5), rand(8 * c, s=0.1),
                rand(c, 4 * c, s=(4 * c) ** -0.5), rand(c, s=0.1), 1 + rand(c, s=0.1),
                rand(c, s=0.1))
        fn, ref, kw = ffn.geglu_ffn, ffn.geglu_ffn_reference, {"residual": True}
    elif kind.startswith("K2"):
        b, s, c = shape
        temporal = kind == "K2 temporal"
        assert attn_block.fused_route(s, c, c, temporal)
        args = (rand(b, s, c), 1 + rand(c, s=0.1), rand(c, s=0.1),
                *[rand(c, c, s=c**-0.5) for _ in range(4)], rand(c, s=0.1), 8)
        fn, ref = attn_block.self_attention_block, attn_block.self_attention_block_reference
        kw = {"temporal": temporal, "pe": rand(s, c) if temporal else None}
    else:
        b, s, hd = shape
        args = (rand(b, s, hd), rand(b, s, hd), rand(b, s, hd), 8)
        fn, ref = ((ta.temporal_attention, ta.temporal_attention_reference) if kind == "K3"
                   else (ta.spatial_attention, ta.spatial_attention_reference))
        kw = {}
    before = fn.launches
    _check(fn(*args, **kw), ref(*args, **kw))
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"cache_encoder": True},
                                  {"cache_encoder": True, "cache_sub": 1}])
def test_deepcache_write_is_the_exact_forward_on_the_card(rand, mode):
    """A depth-1 write step of a narrow UNet (80/160/160/160 channels, two
    heads: head dims 40 and 80, which K2's spatial mode takes at every
    level) is the exact forward bit for bit on the card, and a read fed its
    cache agrees with it."""
    from latentsync_tpu_torch.config import MotionModuleConfig, UNet3DConfig
    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
    from latentsync_tpu_torch.utils.convert import init_random_

    cfg = UNet3DConfig(block_out_channels=(80, 160, 160, 160), layers_per_block=1,
                       norm_num_groups=8, cross_attention_dim=384, attention_head_dim=2,
                       motion_module=MotionModuleConfig(num_attention_heads=2))
    unet = init_random_(UNet3DConditionModel(cfg), seed=0).to("cuda", torch.bfloat16).eval()
    x, audio = rand(2, 13, 16, 32, 32), rand(2, 16, 50, 384)
    t = torch.tensor([981, 451], device="cuda")
    with torch.inference_mode():
        base = unet(x, t, audio)
        eps, cache = unet(x, t, audio, cache_depth=1, **mode)
        read, _ = unet(x, t, audio, deep_cache=cache, cache_depth=1, cache_read=True, **mode)
    assert torch.equal(eps, base)
    err = float((read.float() - base.float()).norm() / base.float().norm())
    assert bool(torch.isfinite(read).all()) and err <= 5e-2, err


@pytest.mark.cuda
@pytest.mark.parametrize("per_frame", [False, True], ids=["constant", "per_frame"])
def test_device_restore_on_the_card_matches_the_cpu(rand, per_frame):
    """``restore_frames_device`` (no kernel of this repository: library ops)
    on the card against the same function on the CPU: within 1 code on at
    most 0.1 % of bytes, and the same bytes for any chunk size."""
    import numpy as np

    from latentsync_tpu_torch.ops.restore import restore_frames_device

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (6, 270, 300, 3), dtype=np.uint8)
    faces = rng.integers(0, 256, (6, 200, 200, 3), dtype=np.uint8)
    mats = np.repeat(np.array([[0.8, 0.0, -20.0], [0.0, 0.8, -15.0]])[None], 6, 0)
    if per_frame:
        mats = mats + rng.normal(0, 0.02, mats.shape) * np.array([1, 1, 40.0])
    got = restore_frames_device(frames, faces, mats, device="cuda")
    want = restore_frames_device(frames, faces, mats, device="cpu")
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert np.array_equal(restore_frames_device(frames, faces, mats, chunk=5, device="cuda"), got)


@pytest.mark.cuda
def test_whisper_decoder_step_on_the_card_matches_the_cpu(rand):
    """One KV-cached decoder step and the teacher-forced logits of a narrow
    whisper decoder in f32, card against CPU, within 1e-4 of the largest
    |logit|."""
    from latentsync_tpu_torch.config import WhisperConfig
    from latentsync_tpu_torch.models.whisper_decoder import WhisperTextDecoder
    from latentsync_tpu_torch.utils.convert import init_random_

    cfg = WhisperConfig(n_vocab=600, n_text_ctx=32, n_text_state=128, n_text_head=4,
                        n_text_layer=2)
    cpu = init_random_(WhisperTextDecoder(cfg), seed=3).eval()
    card = WhisperTextDecoder(cfg).cuda().eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.n_vocab, (2, 5), generator=gen)
    xa = torch.randn(2, 50, cfg.n_text_state, generator=gen) * 0.3
    with torch.inference_mode():
        outs = []
        for dec, dev in ((cpu, "cpu"), (card, "cuda")):
            k, v = dec.audio_kv(xa.to(dev))
            kc, vc = dec.new_cache(2)
            steps = [dec.step(tokens[:, p].to(dev), p, kc, vc, k, v).cpu() for p in range(5)]
            outs.append((torch.stack(steps, 1), dec(tokens.to(dev), xa.to(dev)).cpu()))
    (cpu_steps, cpu_full), (card_steps, card_full) = outs
    scale = float(cpu_full.abs().max())
    for got, want in ((card_steps, cpu_steps), (card_full, cpu_full), (card_steps, card_full)):
        assert float((got - want).abs().max()) <= 1e-4 * scale
