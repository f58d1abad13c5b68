"""The arithmetic of K2's one-launch temporal kernel, emulated in plain torch.

``csrc/temporal_block.cuh`` (``self_attention_block`` in temporal mode on the
card) cannot run without a card, so what it computes is kept testable here.
``emulate_temporal_block`` repeats its walk: row tiles of whole sequences,
each padded to 16 MT rows (MT = 1 up to 16 frames, 2 up to 24; 128 rows a
tile at MT = 1, 64 at MT = 2; rows past F or past the batch zero-filled,
their keys masked, dropped),
bf16 LN(x) + pe once a row, per head ONE product
of the tile against the head's rows of wq, wk and wv (64-wide k-tiles, the
last one zero-filled, f32 accumulation) rounded to bf16, the 16 x 16 softmax
of each (sequence, head) with bf16 probabilities and an f32 row sum, the
head's output columns rounded to bf16, then the output product with bias
and residual in f32 and one rounding (at head dim 40 in the kernel, in
passes of 160 columns onto accumulators that start at residual + bias; at
80 on the GEMM template).

The emulation is held against the port's plain version
(``self_attention_block_reference``) at ragged shapes (a batch that is no
multiple of the row tile, C and inner no multiple of 64) and at both served
widths, and against the JAX package's Pallas block kernel in interpret mode.
Tolerance: 2^-6 * max(1, max|plain|), the one the card check
(``chip_smoke.py``) holds the kernel to, about two bf16 ulps at the output's
top binade: the kernel rounds the probabilities to bf16 where the plain
version keeps them in f32, and sums in another order.

The register code that has no arithmetic of its own is mirrored in Python:
the q/k/v accumulator fragments handed to ``mma.sync`` as they stand, the
``movmatrix`` transposition of v, at MT = 2 the k / v rows written to the
shared tile and read back as ldmatrix fragments, and the host's shape
limits (shared memory per head dim and row tiles) and ring schedule.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu_torch.ops import attn_block as p_ab

TOL_REL = 2.0**-6
BF = torch.bfloat16
BK = 64             # bf16 of one k-tile
TF = 16             # rows of an m16 tile
MAX_F = 24          # frames of a sequence, at most
VPL = 5             # 16-byte vectors a lane in the LayerNorm pass
SMEM_MAX = 232448   # dynamic shared memory a block may have
# head dim -> warpgroups (of 64 rows), ring stages, lanes an x row, the
# columns of a pass of the output product in the kernel (at 80 none: it runs
# on the GEMM template, from the attention output in device memory)
CFG = {40: (2, 3, 8, 160), 80: (2, 2, 16, 0)}


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def product(a: torch.Tensor, b: torch.Tensor, init=None) -> torch.Tensor:
    """a (M, K) bf16, b (N, K) bf16 -> f32 (M, N): 64-wide k-tiles, the last
    one zero-filled, accumulated tile by tile onto `init` (or zeros)."""
    m, k = a.shape
    kp = -(-k // BK) * BK
    ap = torch.zeros(m, kp, dtype=BF)
    bp = torch.zeros(b.shape[0], kp, dtype=BF)
    ap[:, :k], bp[:, :k] = a, b
    acc = torch.zeros(m, b.shape[0]) if init is None else init.clone()
    for k0 in range(0, kp, BK):
        acc = acc + ap[:, k0:k0 + BK].float() @ bp[:, k0:k0 + BK].float().t()
    return acc


def ln_rows(x, ln_w, ln_b, eps, pe, frame=None, frames=TF):
    """bf16(LN(x)) [+ pe[frame] in bf16 where frame < frames]: two-pass f32
    statistics (`frame`: each row's frame, row % 16 by default)."""
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / x.shape[-1]
    var = ((xf - mu) ** 2).sum(-1, keepdim=True) / x.shape[-1]
    h = ((xf - mu) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()).to(BF)
    if pe is not None:
        frame = torch.arange(x.shape[0]) % TF if frame is None else frame
        real = frame < frames
        add = torch.zeros(x.shape[0], x.shape[1])
        add[real] = pe.to(BF).float()[frame[real]]
        h = torch.where(real[:, None], (h.float() + add).to(BF), h)
    return h


def attend(q, k, v, scale, frames=TF):
    """(sequences, 16 MT, D) bf16 each -> bf16 o: f32 logits (keys past
    `frames` at -inf), p = exp((s - max) scale) rounded to bf16 for the value
    product, the row sum over the f32 p, the output multiplied by its
    reciprocal."""
    s = q.float() @ k.float().transpose(1, 2)
    s[:, :, frames:] = -torch.inf
    p = torch.exp((s - s.amax(-1, keepdim=True)) * scale)
    inv = 1.0 / p.sum(-1, keepdim=True)
    return ((p.to(BF).float() @ v.float()) * inv).to(BF)


def row_tiles(f: int) -> int:
    """MT: m16 row tiles a sequence (one up to 16 frames, two up to 24)."""
    assert 1 <= f <= MAX_F
    return 1 if f <= TF else 2


def rows_of_tile(d: int, mt: int = 1) -> int:
    """A block's rows: its warpgroups' (one at MT = 2, where the shared k / v
    tile takes the second's room)."""
    return 64 * (CFG[d][0] if mt == 1 else 1)


def emulate_temporal_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, pe=None, eps=1e-6):
    b, f, c = x.shape
    mt = row_tiles(f)
    ts = TF * mt  # tile rows of a sequence
    inner = wq.shape[0]
    d = inner // heads
    bm = rows_of_tile(d, mt)
    tiles = -(-b * ts // bm)
    idx = torch.arange(tiles * bm)
    frame = idx % ts
    real = (frame < f) & (idx // ts < b)  # tile rows that hold a row of x
    xp = torch.zeros(tiles * bm, c, dtype=BF)  # the other rows: zero-filled copies
    xp[real] = x.reshape(b * f, c)
    out = torch.empty(tiles * bm, c, dtype=BF)
    for t in range(tiles):
        xt = xp[t * bm:(t + 1) * bm]
        a = ln_rows(xt, ln_w, ln_b, eps, pe, frame[t * bm:(t + 1) * bm], f)
        o = torch.zeros(bm, inner, dtype=BF)
        for h in range(heads):
            rows = slice(h * d, (h + 1) * d)
            qkv = product(a, torch.cat([wq[rows], wk[rows], wv[rows]])).to(BF)  # one ring stage
            q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(bm // ts, ts, d) for i in range(3))
            o[:, rows] = attend(q, k, v, 1.0 / math.sqrt(d), f).reshape(bm, d)
        no = CFG[d][3]
        if no:  # in the kernel: the products add onto residual + bias
            init = xt.float() + bo.float()
            y = torch.cat([product(o, wo[n0:n0 + no], init[:, n0:n0 + no])
                           for n0 in range(0, c, no)], dim=1)
        else:  # the GEMM template: bias, then residual, after the product
            y = product(o, wo) + bo.float() + xt.float()
        out[t * bm:(t + 1) * bm] = y.to(BF)
    return out[real].reshape(b, f, c)


# ---------------------------------------------------------------------------
# mirrors of the register and host code
# ---------------------------------------------------------------------------


def accumulator_fragments(mat: torch.Tensor):
    """The wgmma / mma.sync accumulator layout of a (16, N) tile: lane
    4g + t holds, for each 8-column tile j, [M[g, 8j+2t], M[g, 8j+2t+1],
    M[g+8, 8j+2t], M[g+8, 8j+2t+1]] (acc[4j..4j+3])."""
    n = mat.shape[1]
    frags = torch.empty(32, n // 2)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(n // 8):
            frags[lane, 4 * j:4 * j + 4] = torch.stack(
                [mat[g, 8 * j + 2 * t], mat[g, 8 * j + 2 * t + 1],
                 mat[g + 8, 8 * j + 2 * t], mat[g + 8, 8 * j + 2 * t + 1]])
    return frags


def mma16816(a_frags, b_frags):
    """mma.sync m16n8k16 from the 32 lanes' fragments: a (32, 4 pairs),
    b (32, 2 pairs), each pair (low, high) -> the (16, 8) product."""
    a = torch.zeros(16, 16)
    bm = torch.zeros(16, 8)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                        (g + 8, 2 * t + 8))):
            a[row, col], a[row, col + 1] = a_frags[lane][r]
        for r, k0 in enumerate((2 * t, 2 * t + 8)):
            bm[k0, g], bm[k0 + 1, g] = b_frags[lane][r]
    return a @ bm


def movmatrix_trans(pairs):
    """movmatrix.m8n8.trans.b16: lane 4g + t holds (M[g, 2t], M[g, 2t+1])
    and gets (M[2t, g], M[2t+1, g])."""
    mat = torch.zeros(8, 8)
    for lane in range(32):
        g, t = divmod(lane, 4)
        mat[g, 2 * t], mat[g, 2 * t + 1] = pairs[lane]
    return [(mat[2 * (lane % 4), lane // 4], mat[2 * (lane % 4) + 1, lane // 4])
            for lane in range(32)]


def kv_row_bytes(d: int) -> int:
    """A row of the MT = 2 k / v tile, odd_row_bytes (csrc/mma_sync.cuh): D
    bf16 padded to an odd number of 16-byte chunks."""
    return ((d // 8) | 1) * 16


def smem_bytes(d: int, c: int, inner: int, mt: int = 1) -> int:
    """launch<D, MT>'s dynamic shared memory: the ln region, the o region
    where the output product runs in the kernel, the ring, at MT = 2 the
    k / v tile, and 1 KB to align the base."""
    _, stages, _, no = CFG[d]
    bm = rows_of_tile(d, mt)
    kt = lambda n: -(-n // BK)  # noqa: E731
    return (kt(c) + (kt(inner) if no else 0)) * bm * 128 \
        + stages * max(3 * d, no) * 128 + (2 * bm * kv_row_bytes(d) if mt == 2 else 0) + 1024


def kernel_takes(c: int, inner: int, heads: int, f: int = TF) -> bool:
    """temporal_block()'s host check."""
    if c % 8 or inner % heads or not 1 <= f <= MAX_F:
        return False
    d = inner // heads
    return d in CFG and c <= 8 * VPL * CFG[d][2] \
        and smem_bytes(d, c, inner, row_tiles(f)) <= SMEM_MAX


def ring_schedule(heads: int, c: int, inner: int, d: int):
    """The loader's decode of k-tile li of a row tile (load() in the kernel)."""
    ktc, kti = -(-c // BK), -(-inner // BK)
    no = CFG[d][3]
    n_qkv = heads * ktc
    per_tile = n_qkv + (-(-c // no) * kti if no else 0)
    out = []
    for li in range(per_tile):
        if li < n_qkv:
            out.append(("qkv", li // ktc, li % ktc))
        else:
            j = li - n_qkv
            out.append(("out", j // kti, j % kti))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _r(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(BF)


def _inputs(seed, b, c, inner, f=TF):
    rng = np.random.default_rng(seed)
    return (_r(rng, b, f, c), 1 + _r(rng, c, s=0.1), _r(rng, c, s=0.1),
            *[_r(rng, inner, c, s=c**-0.5) for _ in range(3)], _r(rng, c, inner, s=inner**-0.5),
            _r(rng, c, s=0.1)), _r(rng, f, c)


def _within(got, plain):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    plain = np.asarray(plain.float() if isinstance(plain, torch.Tensor) else plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


@pytest.mark.parametrize("b,c,heads", [
    (13, 120, 3),     # M = 208: two row tiles, the second 80 rows; K = 120: a short k-tile
    (8, 200, 5),      # K = 200 = 3 x 64 + 8, the output in two passes (160 + 40)
    (1049, 160, 4),   # M = 16784: 132 row tiles, the last one 16 rows
    (2, 320, 8),      # the served width at C = 320, one partial row tile
    (3, 160, 2),      # head dim 80: o through device memory
    (5, 640, 8),      # the served width at C = 640
])
def test_temporal_block_emulation_matches_plain_version(b, c, heads):
    args, pe = _inputs(b * c + heads, b, c, c)
    assert kernel_takes(c, c, heads)
    got = emulate_temporal_block(*args, heads, pe)
    _within(got, p_ab.self_attention_block_reference(*args, heads, temporal=True, pe=pe))


@pytest.mark.parametrize("b,c,heads", [(4, 120, 3), (2, 160, 2)])
def test_temporal_block_emulation_matches_the_pallas_kernel(b, c, heads):
    """The JAX package's block kernel (head-major fold of the 16 frames) in
    interpret mode; its weights are (in, out), LN parameters and bias f32."""
    (x, ln_w, ln_b, wq, wk, wv, wo, bo), pe = _inputs(7 * b + c, b, c, c)
    got = emulate_temporal_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, pe)
    jb = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    jf = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    ref = j_ab.self_attention_block(jb(x), jf(ln_w), jf(ln_b), jb(wq.t()), jb(wk.t()),
                                    jb(wv.t()), jb(wo.t()), jf(bo), heads, temporal=True,
                                    pe=jb(pe), interpret=True)
    _within(got, np.asarray(jnp.asarray(ref, dtype=jnp.float32)))


@pytest.mark.parametrize("b,c,heads,f", [
    (13, 120, 3, 4),   # one row tile a sequence, 12 padded rows; two block row tiles
    (9, 320, 8, 8),    # the served width at C = 320, F = 8
    (5, 320, 8, 24),   # two row tiles a sequence: 64-row blocks, keys 24-31 masked
    (3, 640, 8, 24),   # head dim 80 at F = 24: o through device memory, its F rows only
    (4, 160, 2, 17),   # one frame past a tile
    (3, 200, 5, 1),    # a single frame
])
def test_temporal_block_emulation_any_frames_matches_plain_version(b, c, heads, f):
    args, pe = _inputs(b * c + heads + f, b, c, c, f)
    assert kernel_takes(c, c, heads, f)
    got = emulate_temporal_block(*args, heads, pe)
    _within(got, p_ab.self_attention_block_reference(*args, heads, temporal=True, pe=pe))


@pytest.mark.parametrize("b,c,heads,f", [(4, 120, 3, 8), (2, 160, 2, 24)])
def test_temporal_block_emulation_any_frames_matches_the_pallas_kernel(b, c, heads, f):
    (x, ln_w, ln_b, wq, wk, wv, wo, bo), pe = _inputs(11 * b + c + f, b, c, c, f)
    got = emulate_temporal_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, pe)
    jb = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    jf = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    ref = j_ab.self_attention_block(jb(x), jf(ln_w), jf(ln_b), jb(wq.t()), jb(wk.t()),
                                    jb(wv.t()), jb(wo.t()), jf(bo), heads, temporal=True,
                                    pe=jb(pe), interpret=True)
    _within(got, np.asarray(jnp.asarray(ref, dtype=jnp.float32)))


@pytest.mark.parametrize("d", [40, 80])
def test_kv_tile_round_trip_feeds_ldmatrix(d):
    """MT = 2: the two warps of a sequence write their k and v accumulator
    tiles to the shared tile (row 16 warp + g, + 8; columns 8j + 2t), and
    ldmatrix at the kernel's lane addresses (x4 for k: keys 16kt + (lane & 7)
    + 8 (lane >> 4), column half (lane >> 3) & 1; an x2 k8 tail; x2.trans for
    v at rows 16kq + (lane & 15)) gives the exact products of one 32-key
    sequence: q k^T and p v from q's accumulators as they stand."""
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2 * TF, d)).astype(np.float32))
               for _ in range(3))
    kvb = kv_row_bytes(d) // 2  # in elements
    tile = torch.full((2, 2 * TF, kvb), float("nan"))  # k rows, v rows; the padding unread
    for warp in range(2):
        acc = accumulator_fragments(torch.cat([k, v], dim=1)[TF * warp:TF * (warp + 1)])
        for lane in range(32):
            g, t = divmod(lane, 4)
            for j in range(d // 8):
                for kv in range(2):
                    a = acc[lane, 4 * (kv * (d // 8) + j):4 * (kv * (d // 8) + j) + 4]
                    row, col = TF * warp + g, 8 * j + 2 * t
                    tile[kv, row, col:col + 2] = a[0:2]
                    tile[kv, row + 8, col:col + 2] = a[2:4]

    def ldsm(mat, addr, count, trans=False):  # the lanes' pairs of `count` 8 x 8 matrices
        out = []
        for lane in range(32):
            g, t = divmod(lane, 4)
            regs = []
            for j in range(count):
                if trans:
                    r0, c0 = addr(8 * j + 2 * t)
                    r1, _ = addr(8 * j + 2 * t + 1)
                    regs.append((mat[r0, c0 + g], mat[r1, c0 + g]))
                else:
                    r, c0 = addr(8 * j + g)
                    regs.append((mat[r, c0 + 2 * t], mat[r, c0 + 2 * t + 1]))
            out.append(regs)
        return out

    for mt in range(2):  # each warp's 16 query rows against the sequence's 32 keys
        qa_all = accumulator_fragments(q[TF * mt:TF * (mt + 1)])
        s = torch.zeros(TF, 2 * TF)
        for kk in range(-(-d // 16)):
            j0, j1 = 2 * kk, 2 * kk + 1
            qa = [[(qa_all[ln, 4 * j0], qa_all[ln, 4 * j0 + 1]),
                   (qa_all[ln, 4 * j0 + 2], qa_all[ln, 4 * j0 + 3]),
                   *([(qa_all[ln, 4 * j1], qa_all[ln, 4 * j1 + 1]),
                      (qa_all[ln, 4 * j1 + 2], qa_all[ln, 4 * j1 + 3])] if j1 < d // 8
                     else [(torch.tensor(0.0),) * 2] * 2)] for ln in range(32)]
            for kt in range(2):
                if 16 * kk + 16 <= d:
                    b = ldsm(tile[0], lambda ln: (16 * kt + (ln & 7) + (ln >> 4) * 8,
                                                  16 * kk + ((ln >> 3) & 1) * 8), 4)
                    s[:, 16 * kt:16 * kt + 8] += mma16816(qa, [[r[0], r[1]] for r in b])
                    s[:, 16 * kt + 8:16 * kt + 16] += mma16816(qa, [[r[2], r[3]] for r in b])
                else:  # the k8 tail: A's upper half is zero, B's second pair unused
                    b = ldsm(tile[0], lambda ln: (16 * kt + (ln & 15), 16 * kk), 2)
                    zero = (torch.tensor(0.0),) * 2
                    s[:, 16 * kt:16 * kt + 8] += mma16816(qa, [[r[0], zero] for r in b])
                    s[:, 16 * kt + 8:16 * kt + 16] += mma16816(qa, [[r[1], zero] for r in b])
        torch.testing.assert_close(s, q[TF * mt:TF * (mt + 1)] @ k.t(), rtol=1e-5, atol=1e-5)
        p = torch.softmax(s, dim=-1)
        o = torch.zeros(TF, d)
        for kq in range(2):
            pf = accumulator_fragments(p[:, 16 * kq:16 * kq + 16])
            pa = [[(pf[ln, 0], pf[ln, 1]), (pf[ln, 2], pf[ln, 3]), (pf[ln, 4], pf[ln, 5]),
                   (pf[ln, 6], pf[ln, 7])] for ln in range(32)]
            for j in range(d // 8):
                b = ldsm(tile[1], lambda ln: (16 * kq + (ln & 15), 8 * j), 2, trans=True)
                o[:, 8 * j:8 * j + 8] += mma16816(pa, b)
        torch.testing.assert_close(o, p @ v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [40, 80])
def test_accumulator_fragments_feed_mma_sync_as_they_stand(d):
    """q's accumulator tiles 2kk, 2kk+1 are q k^T's A fragment of k-step kk;
    k's rows g (keys 0-7) and g + 8 (keys 8-15) its B fragments; the
    probabilities' two 8-key tiles p v's A fragment; v's 8 x 8 tiles,
    transposed by movmatrix, p v's B fragments (the kernel's index code)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((TF, d)).astype(np.float32)) for _ in range(3))
    acc = accumulator_fragments(torch.cat([q, k, v], dim=1))  # one head's q | k | v
    dt, ks = d // 8, -(-d // 16)
    pair = lambda lane, i: (acc[lane, i], acc[lane, i + 1])  # noqa: E731
    zero = (torch.tensor(0.0), torch.tensor(0.0))
    s = torch.zeros(TF, TF)
    for nt in range(2):
        for kk in range(ks):
            j0, j1 = 2 * kk, 2 * kk + 1
            qa = [[pair(ln, 4 * j0), pair(ln, 4 * j0 + 2),
                   pair(ln, 4 * j1) if j1 < dt else zero,
                   pair(ln, 4 * j1 + 2) if j1 < dt else zero] for ln in range(32)]
            kb = [[pair(ln, 4 * (dt + j0) + 2 * nt),
                   pair(ln, 4 * (dt + j1) + 2 * nt) if j1 < dt else zero] for ln in range(32)]
            s[:, 8 * nt:8 * nt + 8] += mma16816(qa, kb)
    torch.testing.assert_close(s, q @ k.t(), rtol=1e-5, atol=1e-5)

    p = torch.softmax(s, dim=-1)
    pf = accumulator_fragments(p)  # s[nt][0..3] of each lane: tiles nt = 0, 1
    pa = [[(pf[ln, 0], pf[ln, 1]), (pf[ln, 2], pf[ln, 3]), (pf[ln, 4], pf[ln, 5]),
           (pf[ln, 6], pf[ln, 7])] for ln in range(32)]
    o = torch.zeros(TF, d)
    for j in range(dt):
        jv = 2 * dt + j
        b0 = movmatrix_trans([pair(ln, 4 * jv) for ln in range(32)])
        b1 = movmatrix_trans([pair(ln, 4 * jv + 2) for ln in range(32)])
        o[:, 8 * j:8 * j + 8] = mma16816(pa, [[b0[ln], b1[ln]] for ln in range(32)])
    torch.testing.assert_close(o, p @ v, rtol=1e-5, atol=1e-5)


def test_host_limits_and_ring_schedule():
    """Every served and probed shape fits the block's shared memory (221 KB
    at both served widths); head dims off 40 / 80 and C past the LayerNorm
    pass's reach are refused; the loader's decode walks the consumer's
    order: each head's k-tiles, then each output pass's (none at D = 80,
    where the template runs that product)."""
    for c, heads in ((320, 8), (640, 8), (120, 3), (200, 5), (160, 4), (160, 2)):
        assert kernel_takes(c, c, heads), (c, heads)
    assert smem_bytes(40, 320, 320) == smem_bytes(80, 640, 640) == 226304
    for c, heads in ((72, 9), (400, 10), (1280, 8), (800, 10)):
        assert not kernel_takes(c, c, heads), (c, heads)
    # two row tiles a sequence: one warpgroup a block beside the k / v tile
    assert smem_bytes(40, 320, 320, 2) == 154624 and smem_bytes(80, 640, 640, 2) == 166912
    assert all(kernel_takes(c, c, 8, f) for c in (320, 640) for f in (1, 4, 8, 16, 17, 24))
    assert not kernel_takes(320, 320, 8, 25) and not kernel_takes(320, 320, 8, 0)
    heads, c = 5, 200
    want = [("qkv", h, kt) for h in range(heads) for kt in range(4)] \
        + [("out", nc, kt) for nc in range(2) for kt in range(4)]
    assert ring_schedule(heads, c, c, 40) == want
    assert ring_schedule(8, 640, 640, 80) == \
        [("qkv", h, kt) for h in range(8) for kt in range(10)]
