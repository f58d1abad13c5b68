"""The arithmetic of K10's one-launch int8-in/int8-out GEGLU, emulated in torch.

``csrc/geglu_i8.cu`` (``geglu_ffn_int8io`` on the card) cannot run without a
card, so what it computes is kept testable here. ``emulate_geglu_i8``
repeats its schedule: row blocks (128 rows at C <= 320, 64 above; rows past
M zeros), x dequantized once a row block into bf16 k-tiles of 64 columns
(zeros past C); for each chunk of 64 hidden columns, the value and gate
products of each 32-column half against one weight tile per k-tile (f32
sums tile by tile), the GEGLU epilogue rounded to bf16 (zeros past 4C), and
the chunk's down-projection added onto the f32 result 64 output columns at
a time; at C > 320 two warpgroups each own half of the output pieces and
half of each chunk, and merge their row amax; then + bd, the row scale and
the codes.

The emulation is held against the port's plain version
(``geglu_ffn_int8io_reference``) and against the JAX package's Pallas
``_geglu_i8_kernel`` in interpret mode, with the tolerances of the card test
``check_int8io``: scales within 2^-6 relative, codes within 1 (another
summation order, or the Pallas kernel's approximate erf, can move a value
across a rounding boundary), the dequantized output within
2^-6 * max(1, max|plain|) plus one output quantum; ragged (M, C) and an
all-zero row included.

The kernel's limits are mirrored too: shared memory in each mode, the
registers its accumulators take at each C, the widest C, and the producer's
order of weight tiles against the consumers'; and the `#if` hooks of
``scripts/ffn8_pieces.py`` still fit the kernel's text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import ffn as j_ffn
from latentsync_tpu_torch.ops import ffn as p_ffn
from latentsync_tpu_torch.scripts import ffn8_pieces
from latentsync_tpu_torch.scripts.attn_pieces import hooked_header

TOL_REL = 2.0**-6
BF = torch.bfloat16
BK = 64              # bf16 of a k-tile, hidden columns of a chunk, output columns of a piece
TILE = 64 * 128      # bytes of a weight tile
NPW = 5              # result pieces a warpgroup holds
X_BYTES = 80 * 1024
H_BYTES = 2 * TILE
RED_BYTES = 2 * 64 * 4
BIAS_BYTES = 9 * 640 * 4  # b_up and b_dn at the widest C, f32
BAR_BYTES = 2 * 16 * 8    # a full and an empty mbarrier for up to 16 stages
SMEM_MAX = 232448
CONSUMER_REGS = 232  # setmaxnreg of a consumer warpgroup (the producer keeps 40)


# ---------------------------------------------------------------------------
# mirrors of the kernel's configuration
# ---------------------------------------------------------------------------


def split(c: int) -> bool:
    """The two warpgroups split the output columns above C = 320."""
    return c > 320


def cfg(c: int):
    """(rows a block, weight tiles a stage, stages, dynamic shared memory):
    as many stages as fit beside x, the hidden tiles, the biases and the
    barriers, at most 16."""
    rows, tps = (64, 2) if split(c) else (128, 1)
    fixed = 1024 + X_BYTES + H_BYTES + RED_BYTES + BIAS_BYTES + BAR_BYTES
    stages = min(16, (SMEM_MAX - fixed) // (tps * TILE))
    return rows, tps, stages, fixed + stages * tps * TILE


def pieces(c: int):
    """(k-tiles of x, output pieces, pieces a warpgroup)."""
    kt = -(-c // BK)
    return kt, kt, (kt + 1) // 2 if split(c) else kt


def accumulator_registers(c: int) -> int:
    """f32 registers a thread holds: its result pieces (a 64 x 64 piece is 32
    a thread of a warpgroup) and one chunk half's value and gate (64 x 64)."""
    return 32 * pieces(c)[2] + 32


def loader_order(c: int):
    """The weight tiles of one chunk in ring order, each stage a tuple of its
    tiles: ("up", half, k-tile) or ("down", piece)."""
    kt, np_, npw = pieces(c)
    if split(c):
        return [(("up", 0, k), ("up", 1, k)) for k in range(kt)] \
            + [(("down", p), ("down", npw + p)) for p in range(npw)]
    return [(("up", h, k),) for h in range(2) for k in range(kt)] \
        + [(("down", p),) for p in range(np_)]


def consumer_order(c: int):
    """What each warpgroup multiplies, step by step, in one chunk."""
    kt, np_, npw = pieces(c)
    out = []
    for wg in range(2):
        if split(c):
            steps = [("up", wg, k) for k in range(kt)] + [("down", wg * npw + p)
                                                          for p in range(npw)]
        else:
            steps = [("up", h, k) for h in range(2) for k in range(kt)] \
                + [("down", p) for p in range(np_)]
        out.append(steps)
    return out


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * 0.70710678118654752))


def emulate_geglu_i8(xi, xs, w_up, b_up, w_dn, b_dn):
    m, c = xi.shape
    inner = 4 * c
    rows, _, _, _ = cfg(c)
    kt, np_, npw = pieces(c)
    w_up, w_dn = w_up.to(BF).float(), w_dn.to(BF).float()
    b_up, b_dn = b_up.float(), b_dn.float()
    cp, ip = kt * BK, -(-inner // BK) * BK  # C and inner padded to whole tiles
    wv = torch.zeros(ip, cp)
    wg = torch.zeros(ip, cp)
    wd = torch.zeros(np_ * BK, ip)
    wv[:inner, :c], wg[:inner, :c], wd[:c, :inner] = w_up[:inner], w_up[inner:], w_dn
    codes_out = torch.empty(m, c, dtype=torch.int8)
    scales_out = torch.empty(m, 1)
    for r0 in range(0, m, rows):
        n = min(rows, m - r0)
        x = torch.zeros(rows, cp, dtype=BF)  # dequantized once a row block
        x[:n, :c] = (xi[r0:r0 + n].float() * xs[r0:r0 + n].reshape(-1, 1).float()).to(BF)
        x = x.float()
        acc = torch.zeros(rows, np_ * BK)
        for c0 in range(0, inner, BK):
            hidden = torch.zeros(rows, BK, dtype=BF)  # the chunk's tile
            for half in range(2):  # one warpgroup's half (split) or both in turn
                h0 = c0 + 32 * half
                if h0 >= inner:
                    continue  # zero-filled tiles: hidden stays 0
                up = torch.zeros(rows, 64)  # 32 value columns, then their gates
                b_tile = torch.cat([wv[h0:h0 + 32], wg[h0:h0 + 32]])
                for k0 in range(0, cp, BK):
                    up = up + x[:, k0:k0 + BK] @ b_tile[:, k0:k0 + BK].t()
                cols = torch.arange(h0, h0 + 32)
                hidden[:, 32 * half:32 * half + 32] = (
                    (up[:, :32] + b_up[cols]) * _gelu_erf(up[:, 32:] + b_up[inner + cols])).to(BF)
            for p in range(np_):  # 64 output columns a step, a warpgroup's pieces or all
                acc[:, p * BK:(p + 1) * BK] += hidden.float() @ wd[p * BK:(p + 1) * BK,
                                                                   c0:c0 + BK].t()
        res = acc[:, :c] + b_dn
        if split(c):  # each warpgroup's amax over its pieces, merged
            cut = min(c, npw * BK)
            amax = torch.maximum(res[:, :cut].abs().amax(-1),
                                 res[:, cut:].abs().amax(-1) if cut < c else torch.zeros(rows))
        else:
            amax = res.abs().amax(-1)
        s = amax / 127.0 + 1e-12
        codes_out[r0:r0 + n] = torch.round(res[:n] / s[:n, None]).to(torch.int8)
        scales_out[r0:r0 + n, 0] = s[:n]
    return codes_out, scales_out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _r(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))


def _inputs(seed, m, c):
    """Codes and scales of a random x, bf16 weights in the nn.Linear layout,
    f32 biases (as the card test's ``_i8_args``)."""
    rng = np.random.default_rng(seed)
    xi, xs = p_ffn.quantize_rowwise(_r(rng, m, c))
    return (xi, xs, _r(rng, 8 * c, c, s=c**-0.5).to(BF), _r(rng, 8 * c, s=0.1),
            _r(rng, c, 4 * c, s=(4 * c) ** -0.5).to(BF), _r(rng, c, s=0.1))


def check_int8io(got, ref):
    (gi, gs), (ri, rs) = got, ref
    assert gi.dtype == torch.int8 and gi.shape == ri.shape and gs.shape == rs.shape
    assert bool(torch.isfinite(gs).all())
    assert float(((gs - rs).abs() / rs).max()) <= TOL_REL
    assert int((gi.int() - ri.int()).abs().max()) <= 1
    plain = ri.float() * rs
    err = (gi.float() * gs - plain).abs()
    tol = TOL_REL * max(1.0, float(plain.abs().max())) + rs
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("m,c", [
    (200, 72),    # ragged M, C: a short last k-tile, a half-empty last hidden chunk
    (129, 64),    # one row past a row block
    (130, 200),   # K = 200 = 3 x 64 + 8, inner 800 = 12.5 chunks
    (256, 320),   # the probe's width, two row blocks
    (70, 400),    # the column split with a ragged last piece (7 pieces: 4 + 3)
    (64, 640),    # the widest C: two warpgroups of five pieces
])
def test_geglu_i8_emulation_matches_plain_version(m, c):
    args = _inputs(m + c, m, c)
    check_int8io(emulate_geglu_i8(*args), p_ffn.geglu_ffn_int8io_reference(*args))
    # the codes feed the next call as they are
    first = p_ffn.geglu_ffn_int8io_reference(*args)
    check_int8io(emulate_geglu_i8(*first, *args[2:]),
                 p_ffn.geglu_ffn_int8io_reference(*first, *args[2:]))


@pytest.mark.parametrize("m,c", [(128, 64), (256, 128)])
def test_geglu_i8_emulation_matches_the_pallas_kernel(m, c):
    """The JAX package's ``_geglu_i8_kernel`` in interpret mode (bm = bi =
    128), its weights (in, out), biases f32."""
    xi, xs, w_up, b_up, w_dn, b_dn = _inputs(3 * m + c, m, c)
    got = emulate_geglu_i8(xi, xs, w_up, b_up, w_dn, b_dn)
    jw = lambda w: jnp.asarray(w.float().t().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    oi, os_ = j_ffn.geglu_ffn_int8io(jnp.asarray(xi.numpy()), jnp.asarray(xs.numpy()), jw(w_up),
                                     jnp.asarray(b_up.numpy()), jw(w_dn),
                                     jnp.asarray(b_dn.numpy()), bm=128, bi=128, interpret=True)
    check_int8io(got, (torch.from_numpy(np.array(oi)), torch.from_numpy(np.array(os_))))


def test_geglu_i8_emulation_all_zero_rows():
    """A zero row with zero biases gives scale 1e-12 and zero codes; with the
    biases every zero row gives the same codes."""
    xi, xs, w_up, b_up, w_dn, b_dn = _inputs(9, 300, 320)
    xi[::7] = 0
    oi, os_ = emulate_geglu_i8(xi, xs, w_up, torch.zeros_like(b_up), w_dn,
                               torch.zeros_like(b_dn))
    assert not bool(oi[::7].any()) and bool((os_[::7] == 1e-12).all())
    got = emulate_geglu_i8(xi, xs, w_up, b_up, w_dn, b_dn)
    check_int8io(got, p_ffn.geglu_ffn_int8io_reference(xi, xs, w_up, b_up, w_dn, b_dn))
    assert torch.equal(got[0][::7], got[0][:1].expand_as(got[0][::7]))


def test_shared_memory_registers_and_widest_c():
    """Both modes fit a block's shared memory (a ring of 13 stages of one
    tile, or 6 of two); the accumulators take at most 192 of a consumer
    thread's 232 registers at every C the kernel takes (160 of the result at
    C = 320 and 640); past the widest C a warpgroup would need a sixth
    piece, and the wrapper refuses it."""
    assert cfg(320)[2:] == (13, 229632) and cfg(640)[2:] == (6, 221440)
    assert all(cfg(c)[3] <= SMEM_MAX for c in (64, 320, 328, 640))
    for c in range(8, p_ffn.GEGLU_I8_MAX_C + 1, 8):
        assert pieces(c)[2] <= NPW and accumulator_registers(c) <= 192 < CONSUMER_REGS, c
    assert accumulator_registers(320) == accumulator_registers(640) == 192
    assert pieces(p_ffn.GEGLU_I8_MAX_C + 64)[2] > NPW
    assert cfg(320)[0] == 128 and cfg(328)[0] == 64


@pytest.mark.parametrize("c", [72, 320, 400, 640])
def test_loader_order_is_the_consumers_order(c):
    """A ring stage holds what each warpgroup multiplies at that step (both
    the same tile at C <= 320, one each when they split the columns)."""
    stages = loader_order(c)
    cons = consumer_order(c)
    assert len(stages) == len(cons[0]) == len(cons[1])
    for i, stage in enumerate(stages):
        for wg in range(2):
            assert cons[wg][i] == stage[wg if split(c) else 0]


def _unhooked(hooked: str) -> list:
    """The preprocessor's view of a hooked source with LS_PIECES = 0: each
    hook's #else branch, as lines."""
    kept, skipping = [], []
    for line in hooked.splitlines():
        if line.startswith("#if LS_PIECES"):
            skipping.append(True)
        elif line == "#else" and skipping:
            skipping[-1] = False
        elif line == "#endif" and skipping:
            skipping.pop()
        elif not any(skipping):
            kept.append(line)
    return kept


def test_ffn8_pieces_hooks_fit_the_kernel():
    """``scripts/ffn8_pieces.py`` patches `#if` hooks into a copy of
    ``csrc/geglu_i8.cu`` by exact text: each finds its piece once, and with
    nothing taken out the hooked source is the kernel's."""
    source = (ffn8_pieces._build.SRC_DIR / "geglu_i8.cu").read_text()
    hooked = ffn8_pieces.hooked_kernel()
    for bit, n in ((1, 1), (2, 1), (4, 2), (8, 2), (16, 2)):  # erf, GEGLU, products, copies, x
        assert hooked.count(f"#if LS_PIECES & {bit}\n") == n
    assert _unhooked(hooked) == source.splitlines()
    with pytest.raises(ValueError, match="has moved"):
        hooked_header(source.replace("kk | ks", "ks | kk"), ffn8_pieces.HOOKS, "ffn8_pieces")
