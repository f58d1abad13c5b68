"""The arithmetic of the bf16 GEMM template, emulated in plain torch.

``csrc/gemm.cuh`` (the products of K1 ``geglu_ffn``, K2
``self_attention_block``, K5 and K9 ``qkv_proj``) cannot run without a
card, so what it computes is kept testable here. ``product`` repeats the K
loop: 64-wide k-tiles with a zero-filled last one, f32 accumulation tile by
tile; ``ln_rows`` the row pass that prepares A once a row (two-pass f32
statistics, LN output rounded to bf16);
``epilogue`` the bias / GEGLU / residual arithmetic in f32 with one final
rounding. From them: the GEGLU feed-forward, q/k/v from one read of x, and
the self-attention block's two projections around the plain cores.

Each emulation is held against the port's plain version
(``geglu_ffn_reference``, ``qkv_proj_reference``,
``self_attention_block_reference``) at small ragged shapes, and against
the JAX package's Pallas kernels ``_geglu_kernel`` and ``_qkv_kernel`` in
interpret mode where their row blocks fit (M a multiple of 128), on bf16
inputs made from a numpy seed. Tolerance: 2^-6 * max(1, max|plain|), the one
the card check (``chip_smoke.py``) holds the kernels to, about two bf16 ulps
at the output's top binade: the emulation sums in another order than the
plain version, and the Pallas GEGLU uses an approximate erf within one bf16
ulp of the exact one.

The layout code that has no arithmetic is mirrored in Python and checked
for what the kernel relies on: the 128-byte swizzle's address function, the
quad transpose of the epilogue with the accumulator fragment layout, and
the host's tile picker at every served shape.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.ops import temporal_attention as p_ta
from test_torch_temporal_block_core import emulate_temporal_block
from test_torch_temporal_block_core import ln_rows as temporal_ln_rows

TOL_REL = 2.0**-6
BK = 64      # bf16 of one k-tile
BM = 128     # rows a block
SMS = 132    # blocks a launch should at least have
BF = torch.bfloat16

MS = [1, 130, 200]
CS = [64, 72, 320]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) bf16, b (N, K) bf16 -> f32 (M, N): the kernel's K loop."""
    m, k = a.shape
    kp = -(-k // BK) * BK
    ap = torch.zeros(m, kp, dtype=BF)
    bp = torch.zeros(b.shape[0], kp, dtype=BF)
    ap[:, :k], bp[:, :k] = a, b  # chunks past K are zero-filled
    acc = torch.zeros(m, b.shape[0])
    for k0 in range(0, kp, BK):
        acc = acc + ap[:, k0:k0 + BK].float() @ bp[:, k0:k0 + BK].float().t()
    return acc


def ln_rows(x, ln_w, ln_b, eps=1e-6):
    """The row pass: bf16(LN(x)), once a row."""
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / x.shape[-1]
    var = ((xf - mu) ** 2).sum(-1, keepdim=True) / x.shape[-1]
    return ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(BF)


def epilogue(acc, bias=None, gate=None, bias_gate=None, res=None):
    """f32 bias, value * gelu_erf(gate), residual; one rounding to bf16."""
    v = acc if bias is None else acc + bias.float()
    if gate is not None:
        g = gate if bias_gate is None else gate + bias_gate.float()
        v = v * p_ffn.gelu_erf(g)
    if res is not None:
        v = v + res.float()
    return v.to(BF)


def emulate_geglu_ffn(x, w_up, b_up, w_dn, b_dn, ln_w=None, ln_b=None, residual=False):
    inner = w_up.shape[0] // 2
    a = x if ln_w is None else ln_rows(x, ln_w, ln_b)
    hidden = epilogue(product(a, w_up[:inner]), b_up[:inner],
                      product(a, w_up[inner:]), b_up[inner:])
    return epilogue(product(hidden, w_dn), b_dn, res=x if residual else None)


def emulate_qkv(x, wq, wk, wv):
    return tuple(epilogue(product(x, w)) for w in (wq, wk, wv))


def emulate_self_attention_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, temporal, pe):
    """Temporal mode: the one-launch kernel's order (row tiles, per-head
    products, bf16 probabilities; test_torch_temporal_block_core.py).
    Spatial mode: the row pass, one launch of three operands around the
    plain core, the output product."""
    if temporal:
        return emulate_temporal_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, pe)
    b, s, c = x.shape
    x2 = x.reshape(b * s, c)
    a = ln_rows(x2, ln_w, ln_b)
    q, k, v = (epilogue(product(a, w)).reshape(b, s, -1) for w in (wq, wk, wv))
    o = p_ta.spatial_attention_reference(q, k, v, heads, 1.0 / math.sqrt(wq.shape[0] // heads))
    return epilogue(product(o.reshape(b * s, -1), wo), bo, res=x2).reshape(b, s, c)


def _r(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(BF)


def _ffn_inputs(seed, m, c):
    rng = np.random.default_rng(seed)
    return (_r(rng, m, c), _r(rng, 8 * c, c, s=c**-0.5), _r(rng, 8 * c, s=0.1),
            _r(rng, c, 4 * c, s=(4 * c) ** -0.5), _r(rng, c, s=0.1),
            1 + _r(rng, c, s=0.1), _r(rng, c, s=0.1))


def _within(got, plain):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    plain = np.asarray(plain.float() if isinstance(plain, torch.Tensor) else plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


def _jnp(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.float32))


# ---------------------------------------------------------------------------
# against the plain versions, ragged shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("m", MS)
def test_geglu_emulation_matches_plain_version(m, c):
    x, w_up, b_up, w_dn, b_dn, ln_w, ln_b = _ffn_inputs(100 * m + c, m, c)
    for ln, residual in (((ln_w, ln_b), True), ((None, None), False)):
        got = emulate_geglu_ffn(x, w_up, b_up, w_dn, b_dn, *ln, residual=residual)
        _within(got, p_ffn.geglu_ffn_reference(x, w_up, b_up, w_dn, b_dn, *ln,
                                               residual=residual))


@pytest.mark.parametrize("c,inner", [(64, 64), (72, 200), (320, 72)])
@pytest.mark.parametrize("m", MS)
def test_qkv_emulation_matches_plain_version(m, c, inner):
    rng = np.random.default_rng(7 * m + c)
    x = _r(rng, m, c)
    ws = [_r(rng, inner, c, s=c**-0.5) for _ in range(3)]
    got = emulate_qkv(x, *ws)
    for g, r in zip(got, p_ffn.qkv_proj_reference(x, *ws)):
        assert g.shape == (m, inner)
        _within(g, r)


@pytest.mark.parametrize("temporal,b,s,c,heads", [(True, 13, 16, 120, 3), (True, 2, 16, 320, 8),
                                                  (False, 2, 65, 64, 4), (False, 1, 1, 72, 3),
                                                  (False, 5, 40, 320, 8)])
def test_block_emulation_matches_plain_version(temporal, b, s, c, heads):
    rng = np.random.default_rng(s * c)
    args = (_r(rng, b, s, c), 1 + _r(rng, c, s=0.1), _r(rng, c, s=0.1),
            *[_r(rng, c, c, s=c**-0.5) for _ in range(4)], _r(rng, c, s=0.1), heads)
    pe = _r(rng, s, c) if temporal else None
    got = emulate_self_attention_block(*args, temporal, pe)
    _within(got, p_ab.self_attention_block_reference(*args, temporal=temporal, pe=pe))


@pytest.mark.parametrize("m,c", [(1, 72), (130, 64), (200, 72)])
def test_int8_chain_emulation_matches_plain_version(m, c):
    """K10's rounding points on whole-row products: bf16(code * scale) once
    a row, the GEGLU rounded to bf16, the f32 down-projection, then the row
    quantization (the one-launch kernel's own chunk schedule is emulated in
    ``test_torch_geglu_i8_core.py``). Against the plain version: scales
    within 2^-6 relative, codes within 1 (another summation order can move a
    value across a rounding boundary)."""
    _, w_up, b_up, w_dn, b_dn, _, _ = _ffn_inputs(31 * m + c, m, c)
    rng = np.random.default_rng(m + c)
    codes, scales = p_ffn.quantize_rowwise(_r(rng, m, c))
    inner = 4 * c
    a = (codes.float() * scales.reshape(-1, 1)).to(BF)  # the dequantizing row pass
    hidden = epilogue(product(a, w_up[:inner]), b_up[:inner],
                      product(a, w_up[inner:]), b_up[inner:])
    got_i, got_s = p_ffn.quantize_rowwise(product(hidden, w_dn) + b_dn.float())
    ref_i, ref_s = p_ffn.geglu_ffn_int8io_reference(codes, scales, w_up, b_up, w_dn, b_dn)
    assert float(((got_s - ref_s).abs() / ref_s).max()) <= TOL_REL
    assert int((got_i.int() - ref_i.int()).abs().max()) <= 1


def test_short_last_k_tile_adds_nothing():
    """K = 72: the second tile holds 8 real columns and 56 zero-filled ones;
    whatever else the same shared memory held before must not enter."""
    rng = np.random.default_rng(5)
    a, b = _r(rng, 130, 72), _r(rng, 40, 72)
    exact = a.double() @ b.double().t()
    _within(product(a, b), exact.float())
    padded_a = torch.cat([a, _r(rng, 130, 56)], dim=1)  # garbage where zeros belong
    assert not torch.allclose(product(padded_a, torch.cat([b, _r(rng, 40, 56)], dim=1)),
                              product(a, b), atol=1e-3)


def test_ln_runs_once_a_row_with_pe_added_in_bf16():
    """K2's temporal LayerNorm pass (``csrc/temporal_block.cuh``; the row
    pass here has no pe) rounds LN(x) to bf16 and THEN adds pe in bf16 (two
    roundings), with pe's row = row mod S: the plain version's order."""
    rng = np.random.default_rng(6)
    x, pe = _r(rng, 48, 72), _r(rng, 16, 72)
    ln_w, ln_b = 1 + _r(rng, 72, s=0.1), _r(rng, 72, s=0.1)
    got = temporal_ln_rows(x, ln_w, ln_b, 1e-6, pe)
    want = p_ffn.layer_norm_f32(x, ln_w, ln_b, 1e-6).to(BF).reshape(3, 16, 72) + pe
    _within(got.reshape(3, 16, 72), want)
    one_rounding = (p_ffn.layer_norm_f32(x, ln_w, ln_b, 1e-6).reshape(3, 16, 72)
                    + pe.float()).to(BF)
    assert not torch.equal(got.reshape(3, 16, 72), one_rounding)


def test_large_inputs_against_f64():
    """Inputs x 30: f32 accumulation over K = 320 and one rounding stay within
    the tolerance of a float64 product."""
    rng = np.random.default_rng(8)
    x = 30 * _r(rng, 130, 320)
    ws = [30 * _r(rng, 72, 320, s=320**-0.5) for _ in range(3)]
    for g, w in zip(emulate_qkv(x, *ws), ws):
        _within(g, (x.double() @ w.double().t()).float())


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode (row blocks of 128)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,c", [(128, 64), (256, 64)])
@pytest.mark.parametrize("has_ln", [True, False])
def test_geglu_emulation_matches_the_pallas_kernel(m, c, has_ln):
    x, w_up, b_up, w_dn, b_dn, ln_w, ln_b = _ffn_inputs(m + c + has_ln, m, c)
    ln = (ln_w, ln_b) if has_ln else (None, None)
    got = emulate_geglu_ffn(x, w_up, b_up, w_dn, b_dn, *ln, residual=has_ln)
    # flax kernels are (in, out); biases and LN parameters f32
    ref = j_ffn.geglu_ffn(
        _jnp(x), _jnp(w_up.t()), jnp.asarray(b_up.float().numpy()), _jnp(w_dn.t()),
        jnp.asarray(b_dn.float().numpy()),
        ln_scale=jnp.asarray(ln_w.float().numpy()) if has_ln else None,
        ln_bias=jnp.asarray(ln_b.float().numpy()) if has_ln else None,
        residual=has_ln, interpret=True)
    _within(got, _np(ref))


@pytest.mark.parametrize("m,c,inner", [(128, 64, 64), (256, 64, 128)])
def test_qkv_emulation_matches_the_pallas_kernel(m, c, inner):
    rng = np.random.default_rng(m + inner)
    x = _r(rng, m, c)
    ws = [_r(rng, inner, c, s=c**-0.5) for _ in range(3)]
    ref = j_ffn.qkv_proj(_jnp(x), *[_jnp(w.t()) for w in ws], interpret=True)
    for g, r in zip(emulate_qkv(x, *ws), ref):
        _within(g, _np(r))


# ---------------------------------------------------------------------------
# layout code mirrored from csrc/wgmma.cuh and csrc/gemm.cuh
# ---------------------------------------------------------------------------


def sw128_offset(r: int, c: int) -> int:
    """Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile."""
    return r * 128 + ((c ^ (r & 7)) << 4)


@pytest.mark.parametrize("rows", [64, 128, 160])
def test_swizzle_is_a_bijection_that_keeps_chunks_whole(rows):
    offs = [sw128_offset(r, c) for r in range(rows) for c in range(8)]
    assert sorted(offs) == list(range(0, rows * 128, 16))  # onto the tile, no chunk split
    for r in range(rows):  # a row's chunks stay inside the row's own 128 bytes
        assert sorted(sw128_offset(r, c) for c in range(8)) == \
            list(range(r * 128, (r + 1) * 128, 16))
    for c in range(8):  # one chunk column of 8 rows lands in 8 different bank groups
        assert len({sw128_offset(r, c) % 128 for r in range(8)}) == 8
    # what the kernel's loads rely on: 32 rows further is the same place + 4096 bytes
    assert all(sw128_offset(r + 32, c) == sw128_offset(r, c) + 4096
               for r in range(rows - 32) for c in range(8))


def quad_transpose(quad):
    """quad[t] = the four values lane t of a quad holds; the kernel's two
    shuffle rounds (xor 1, then xor 2)."""
    v = [list(lane) for lane in quad]
    sent = [[v[t][b] if t & 1 else v[t][b + 1] for b in (0, 2)] for t in range(4)]
    for t in range(4):
        for n, b in enumerate((0, 2)):
            got = sent[t ^ 1][n]
            if t & 1:
                v[t][b] = got
            else:
                v[t][b + 1] = got
    sent = [[v[t][i] if t & 2 else v[t][i + 2] for i in (0, 1)] for t in range(4)]
    for t in range(4):
        for i in (0, 1):
            got = sent[t ^ 2][i]
            if t & 2:
                v[t][i] = got
            else:
                v[t][i + 2] = got
    return v


def test_quad_transpose_gives_each_lane_one_tile():
    quad = [[(t, i) for i in range(4)] for t in range(4)]
    out = quad_transpose(quad)
    for t in range(4):
        assert out[t] == [(s, t) for s in range(4)]  # value t of lanes 0..3, in lane order


@pytest.mark.parametrize("bn", [64, 160])
def test_epilogue_stores_every_element_once(bn):
    """A warpgroup's 64 x BN accumulator in the wgmma fragment layout (lane
    (g, t) of warp w holds columns 8j + 2t, 8j + 2t + 1 of rows 16w + g and
    16w + g + 8 in registers 4j .. 4j + 3), packed in pairs, transposed
    across each quad and stored 8 columns a lane: every element lands once,
    at its own place."""
    out = np.full((64, bn), -1, np.int64)
    label = np.arange(64 * bn).reshape(64, bn)
    for w in range(4):
        for g in range(8):
            for q in range(bn // 32):
                for half, row in ((0, 16 * w + g), (1, 16 * w + g + 8)):
                    quad = [[(label[row, 8 * (4 * q + jj) + 2 * t],
                              label[row, 8 * (4 * q + jj) + 2 * t + 1]) for jj in range(4)]
                            for t in range(4)]
                    for t, pairs in enumerate(quad_transpose(quad)):
                        col8 = 8 * (4 * q + t)
                        flat = [x for pair in pairs for x in pair]
                        assert (out[row, col8:col8 + 8] == -1).all()
                        out[row, col8:col8 + 8] = flat
    np.testing.assert_array_equal(out, label)


def block_walk(block: int, grid: int, tiles_n: int, nb: int, row_tiles: int, kt_all: int,
               stages: int = 3):
    """One block's steps as the kernel takes them: (computed, loaded) lists of
    (row tile, operand, column tile, k-tile). The load cursor starts
    stages - 1 steps ahead and moves on one step behind every product."""
    tiles_row = tiles_n * nb
    total = tiles_row * row_tiles

    def decode(w):
        rt, rem = divmod(w, tiles_row)
        return (rt, *divmod(rem, tiles_n))

    cursor = [block, 0]  # lw, lkt
    loaded = []

    def load():
        if cursor[0] < total:
            loaded.append((*decode(cursor[0]), cursor[1]))
            cursor[1] += 1
            if cursor[1] == kt_all:
                cursor[:] = [cursor[0] + grid, 0]

    for _ in range(stages - 1):
        load()
    computed = []
    for w in range(block, total, grid):
        for t in range(kt_all):
            assert len(loaded) > len(computed)  # the k-tile was asked for before its product
            computed.append((*decode(w), t))
            load()
    return computed, loaded


@pytest.mark.parametrize("grid,tiles_n,nb,row_tiles,kt_all", [
    (264, 2, 3, 1024, 5), (264, 20, 1, 512, 5), (7, 3, 3, 5, 2), (264, 2, 1, 8, 80), (5, 1, 1, 1, 1)])
def test_resident_blocks_cover_every_tile_once_with_loads_ahead(grid, tiles_n, nb, row_tiles,
                                                                kt_all):
    total = tiles_n * nb * row_tiles
    seen = []
    for block in range(min(grid, total)):
        computed, loaded = block_walk(block, min(grid, total), tiles_n, nb, row_tiles, kt_all)
        assert loaded == computed  # the same steps in the same order, nothing loaded in vain
        seen += [step[:3] for step in computed if step[3] == 0]
    assert sorted(seen) == [(rt, op, ct) for rt in range(row_tiles) for op in range(nb)
                            for ct in range(tiles_n)]
    # blocks next to each other start in one row panel, on neighbouring column tiles
    first = [block_walk(b, min(grid, total), tiles_n, nb, row_tiles, kt_all)[0][0]
             for b in range(min(grid, total, tiles_n * nb))]
    assert {f[0] for f in first} == {0}


def pick_bn(m: int, n: int, nb: int = 1, dual: bool = False) -> int:
    """The host's tile picker (csrc/gemm.cuh pick_bn)."""
    blocks160 = -(-m // BM) * nb * -(-n // 160)
    return 160 if not dual and n % 160 == 0 and blocks160 >= SMS else 64


# (M, N, operands, dual) of every product of the served and probed shapes of
# chip_smoke.py: K1's up- and down-projection, K2's q/k/v and output
# projection, K5's three, K9
def _served_products():
    out = []
    for m, c in [(65536, 320), (16384, 640), (4096, 1280), (1024, 1280)]:
        out += [(m, 4 * c, 1, True), (m, c, 1, False)]
    for m, c in [(4096 * 16, 320), (1024 * 16, 640), (64 * 256, 640)]:
        out += [(m, 3 * c, 1, False), (m, c, 1, False)]
    for m, c in [(64 * 1024, 320), (64 * 256, 640)]:
        out += [(m, c, 1, False), (64 * 50, 2 * c, 1, False)]
    for m, c in [(131072, 320), (32768, 640), (8192, 1280)]:
        out.append((m, c, 3, False))
    return out


@pytest.mark.parametrize("m,n,nb,dual", _served_products())
def test_tile_picker_fills_the_card_or_takes_the_smallest_tile(m, n, nb, dual):
    bn = pick_bn(m, n, nb, dual)
    assert bn in ((64,) if dual else (64, 160))
    blocks = -(-m // BM) * nb * -(-n // bn)
    assert blocks >= SMS or bn == 64
    if bn == 160:
        assert n % 160 == 0  # chosen only where it leaves no ragged column tile


def test_tile_picker_at_the_edges():
    assert pick_bn(1, 8) == 64 and pick_bn(1, 8, dual=True) == 64
    assert pick_bn(65536, 320) == 160 and pick_bn(65536, 960) == 160
    assert pick_bn(65536, 1280) == 160 and pick_bn(4096, 1280) == 160
    assert pick_bn(65536, 1024) == 64 and pick_bn(65536, 200) == 64  # 160 would be ragged
    assert pick_bn(65536, 1280, dual=True) == 64  # two accumulator sets: one tile
    assert pick_bn(1024, 1280) == 64  # 8 x 8 blocks of 160 would leave SMs idle
    assert pick_bn(3200, 640) == 64 and pick_bn(8192, 1280, nb=3) == 160
