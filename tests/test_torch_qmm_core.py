"""The arithmetic of K8 (``csrc/qmm.cu``), emulated in plain torch.

K8 is two launches that cannot run without a card: a quantizing row pass
over the rows of x and of the weight (f32 scale, int8 codes at a pitch of K
rounded up to 16 with a zero tail), then the GEMM template's int8 mode
(``csrc/gemm.cuh``): 128-code k-tiles, the short last one zero-filled, int32
accumulation tile by tile, and K8's dequantization in the epilogue,
``bf16(bf16((f32(acc) · ascale) · wscale) + bias)``, with rows past M
loaded as the last row and columns past N read at the last valid pair and
never stored. ``emulate_qmm`` repeats all of it.

K8 is held BITWISE to its plain version on the card, so everything here is
bitwise too: the row pass's plain version (``quantize_rows_reference``)
against ``quantize_weight`` and ``quantize_activations`` (the plain
version's two quantizations) and against the JAX package's weight
quantization; the emulation against ``quantized_matmul_reference`` and
against ``quantized_matmul_pallas`` in interpret mode, on bf16 inputs made
from a numpy seed. Then the layout the int8 mode shares with the bf16 one:
a k-tile row is 128 bytes either way, and its four 32-byte k-steps are
wgmma's k16 in bf16 and k32 in int8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import qmm as j_qmm
from latentsync_tpu_torch.ops import qmm as p_qmm

BF = torch.bfloat16
BM = 128          # rows a block
ROW_BYTES = 128   # a k-tile's row in shared memory
SMS = 132


def pick_bn(m: int, n: int) -> int:
    """The host's tile picker (csrc/gemm.cuh pick_bn), one operand."""
    return 160 if n % 160 == 0 and -(-m // BM) * -(-n // 160) >= SMS else 64


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def product_s8(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Codes (M, kp) and (N, kp) int8 -> int32 (M, N): the K loop over
    128-code k-tiles, the last one zero-filled past kp by the copy itself."""
    kp = xq.shape[1]
    bk = ROW_BYTES  # one byte a code
    kt = -(-kp // bk) * bk
    a = torch.zeros(xq.shape[0], kt, dtype=torch.int64)
    b = torch.zeros(wq.shape[0], kt, dtype=torch.int64)
    a[:, :kp], b[:, :kp] = xq, wq
    acc = torch.zeros(xq.shape[0], wq.shape[0], dtype=torch.int64)
    for k0 in range(0, kt, bk):
        acc += a[:, k0:k0 + bk] @ b[:, k0:k0 + bk].t()
    return acc.to(torch.int32)


def epilogue_s8(acc, ascale, wscale, bias=None):
    """f32(acc) times the row scale, times the column scale, rounded to
    bf16; the bias added in f32 and rounded again."""
    v = ((acc.float() * ascale[:, None]) * wscale[None, :]).to(BF)
    return v if bias is None else (v.float() + bias.to(BF).float()).to(BF)


def emulate_qmm(x, w, bias=None):
    """K8 on x (M, K) bf16, w (N, K): the row pass, then the product over
    whole 128-row x BN-column output tiles with the kernel's clamped edges."""
    m, k = x.shape
    n = w.shape[0]
    kp = p_qmm.code_pitch(k)
    xq, ascale = p_qmm.quantize_rows_reference(x, kp)
    wq, wscale = p_qmm.quantize_rows_reference(w, kp)
    bn = pick_bn(m, n)
    mp, np_ = -(-m // BM) * BM, -(-n // bn) * bn
    rows = torch.clamp(torch.arange(mp), max=m - 1)  # rows past M load the last row
    cols = torch.clamp(torch.arange(np_), max=n - 1)  # so do B's rows past N
    j = torch.arange(np_)
    pair = torch.where(j < n, j, n - 2 + j % 2)  # the epilogue's scales and bias past N
    acc = product_s8(xq[rows], wq[cols])
    b = None if bias is None else bias.to(BF)[pair]
    out = epilogue_s8(acc, ascale[rows], wscale[pair], b)
    return out[:m, :n]  # only these are stored


def _r(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(BF)


def _inputs(seed, m, k, n, bias):
    rng = np.random.default_rng(seed)
    x = _r(rng, m, k)
    x[::7] = 0  # the CFG pass's all-zero audio context
    return x, _r(rng, n, k, s=k**-0.5), _r(rng, n, s=0.1) if bias else None


def _jax_out(x, w, bias):
    """quantized_matmul_pallas in interpret mode on the same bf16 values
    (flax kernel layout (K, N))."""
    jx = jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy().T, dtype=jnp.bfloat16)
    jb = None if bias is None else jnp.asarray(bias.float().numpy(), dtype=jnp.bfloat16)
    out = j_qmm.quantized_matmul_pallas(jx, jw, jb, interpret=True)
    return torch.from_numpy(np.array(jnp.asarray(out, jnp.float32)))


# ---------------------------------------------------------------------------
# the row pass
# ---------------------------------------------------------------------------

ROW_SHAPES = [(136, 24), (320, 320), (40, 328), (7, 1280), (3, 5120)]


@pytest.mark.parametrize("rows,k", ROW_SHAPES)
def test_row_pass_equals_the_plain_quantizations(rows, k):
    """One row pass quantizes x and w: its codes and scales are bitwise the
    plain version's activation quantization (clipped) and weight
    quantization (unclipped: the clip never bites), with a zero tail."""
    rng = np.random.default_rng(rows + k)
    t = _r(rng, rows, k, s=k**-0.5)
    t[1] = 0  # an all-zero row: scale 1e-8/127, zero codes
    kp = p_qmm.code_pitch(k)
    assert kp % 16 == 0 and k <= kp < k + 16
    codes, scale = p_qmm.quantize_rows_reference(t, kp)
    assert codes.dtype == torch.int8 and codes.shape == (rows, kp)
    assert not codes[:, k:].any() and not codes[1].any()
    wq, wscale = p_qmm.quantize_weight(t)
    assert torch.equal(codes[:, :k], wq) and torch.equal(scale, wscale)
    xq, ascale = p_qmm.quantize_activations(t)
    assert torch.equal(codes[:, :k].float(), xq) and torch.equal(scale, ascale[:, 0])
    assert int(codes.abs().max()) == 127 and scale[1] == torch.tensor(1e-8) * (1.0 / 127.0)


@pytest.mark.parametrize("rows,k", ROW_SHAPES[:3])
def test_row_pass_equals_the_jax_quantization(monkeypatch, rows, k):
    """The JAX package quantizes the kernel (K, N) per column before its
    Pallas call: spy on that call and compare codes and scales bitwise, for
    a weight and for x given in the weight's place (the same formula; the
    Pallas kernel's activation clip never bites either)."""
    seen = []
    real = j_qmm._qmm_pallas

    def spy(x, wq, wsc, *a):
        seen.append((np.asarray(wq), np.asarray(wsc)))
        return real(x, wq, wsc, *a)

    monkeypatch.setattr(j_qmm, "_qmm_pallas", spy)
    rng = np.random.default_rng(3 * rows + k)
    t = _r(rng, rows, k)
    t[0] = 0
    j_qmm.quantized_matmul_pallas(jnp.ones((8, k), jnp.bfloat16),
                                  jnp.asarray(t.float().numpy().T, dtype=jnp.bfloat16),
                                  interpret=True)
    (jq, jsc), = seen
    codes, scale = p_qmm.quantize_rows_reference(t)
    np.testing.assert_array_equal(codes.numpy(), jq.T)
    np.testing.assert_array_equal(scale.numpy(), jsc[0])


# ---------------------------------------------------------------------------
# the whole function, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(130, 320, 136), (64, 328, 96), (200, 24, 40),
                                   (1, 640, 160), (129, 384, 320)])
@pytest.mark.parametrize("bias", [True, False])
def test_emulation_is_bitwise_the_plain_version_and_the_pallas_kernel(m, k, n, bias):
    x, w, b = _inputs(m * k + n + bias, m, k, n, bias)
    got = emulate_qmm(x, w, b)
    assert got.dtype == BF and got.shape == (m, n)
    assert torch.equal(got, p_qmm.quantized_matmul_reference(x, w, b))
    assert torch.equal(got.float(), _jax_out(x, w, b))
    want = torch.zeros(n, dtype=BF) if b is None else b
    assert torch.equal(got[::7], want.expand(got[::7].shape))  # zero rows: exactly the bias


def test_accumulators_past_2_24_round_like_the_plain_version():
    """K = 5120 with every code at +-127: |acc| = 127^2 K > 2^24, so f32(acc)
    rounds; the epilogue rounds it as the plain version's acc.float() does."""
    rng = np.random.default_rng(9)
    x = torch.ones(4, 5120, dtype=BF)
    x[1] = -1
    x[2, ::3] = 0.5
    w = torch.from_numpy(np.sign(rng.standard_normal((16, 5120))).astype(np.float32)).to(BF)
    w[0] = 1  # row 2 of x against it: 127 (127 * 3413 + 64 * 1707), odd and above 2^26
    kp = p_qmm.code_pitch(5120)
    acc = product_s8(p_qmm.quantize_rows_reference(x, kp)[0],
                     p_qmm.quantize_rows_reference(w, kp)[0])
    assert int(acc.abs().max()) > 2**24
    assert not torch.equal(acc.float().double(), acc.double())  # some f32(acc) rounded
    assert torch.equal(emulate_qmm(x, w), p_qmm.quantized_matmul_reference(x, w))


@pytest.mark.parametrize("k,tiles", [(320, [128, 128, 64]), (328, [128, 128, 80]),
                                     (384, [128, 128, 128]), (24, [32])])
def test_short_last_k_tile_and_the_zero_tail(k, tiles):
    """K = 320 and 328 end in a short 128-code k-tile (64 and 80 real codes,
    328 with 8 codes of zero tail from the row pass); whatever lies past
    the pitch must not enter, and the tail inside it must be zero."""
    kp = p_qmm.code_pitch(k)
    assert [min(128, kp - k0) for k0 in range(0, kp, 128)] == tiles
    rng = np.random.default_rng(k)
    x, w = _r(rng, 130, k), _r(rng, 40, k)
    xq, _ = p_qmm.quantize_rows_reference(x, kp)
    wq, _ = p_qmm.quantize_rows_reference(w, kp)
    exact = xq.long() @ wq.long().t()
    assert torch.equal(product_s8(xq, wq).long(), exact)
    if kp > k:  # garbage where the row pass writes zeros changes the sum
        dirty = xq.clone()
        dirty[:, k:] = 1
        wd = wq.clone()
        wd[:, k:] = 1
        assert not torch.equal(product_s8(dirty, wd), product_s8(xq, wq))


# ---------------------------------------------------------------------------
# layout the int8 mode shares with the bf16 one
# ---------------------------------------------------------------------------


def sw128_offset(r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile."""
    return r * 128 + ((c ^ (r & 7)) << 4)


@pytest.mark.parametrize("elem_bytes,wgmma_k", [(2, 16), (1, 32)])
def test_k_tile_row_and_k_steps_are_the_same_bytes(elem_bytes, wgmma_k):
    """bf16 (2 bytes, wgmma k16) and int8 (1 byte, k32): a k-tile row is 128
    bytes, a copy 16 bytes (8 or 16 elements), and each of the four 32-byte
    k-steps the descriptor takes reads chunks 2 ks and 2 ks + 1 of every row,
    i.e. elements [wgmma_k ks, wgmma_k (ks + 1)) of the tile, wherever the
    swizzle put them."""
    bk, ce = ROW_BYTES // elem_bytes, 16 // elem_bytes
    assert bk * elem_bytes == 128 and ce * elem_bytes == 16
    assert ROW_BYTES // 32 == 4 and 32 // elem_bytes == wgmma_k
    for ks in range(4):
        elems = set(range(wgmma_k * ks, wgmma_k * (ks + 1)))
        chunks = {e // ce for e in elems}
        assert chunks == {2 * ks, 2 * ks + 1}
        for r in range(16):  # the swizzle moves chunks inside their row only
            offs = {sw128_offset(r, c) for c in chunks}
            assert all(r * 128 <= o < (r + 1) * 128 for o in offs)


@pytest.mark.parametrize("m,n,bn", [(65536, 2560, 160), (65536, 320, 160), (16384, 5120, 160),
                                    (4096, 1280, 160), (1024, 1280, 64), (1024, 10240, 160),
                                    (3200, 320, 64), (3200, 1280, 160), (1000, 328, 64)])
def test_tile_picker_at_k8_shapes(m, n, bn):
    """The int8 mode takes the bf16 mode's column tile: 160 where N is a
    multiple of it and the launch fills the card, else 64."""
    assert pick_bn(m, n) == bn
    assert -(-m // BM) * -(-n // bn) >= SMS or bn == 64
