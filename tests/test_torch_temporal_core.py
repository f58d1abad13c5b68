"""The arithmetic of K3's tensor-core temporal attention core, emulated in torch.

``csrc/temporal_attention.cu`` (``temporal_attention`` on the card) cannot
run without a card, so what it computes is kept testable here.
``emulate_temporal_core`` repeats its walk for every (sequence, head) task:
q, k and v tiles as the cp.async ring lays them out in shared memory (rows
padded to an odd number of 16-byte chunks), q k^T as mma.sync m16n8k16
steps (a k8 step at the end of a head dim with D % 16 == 8) from the
fragments ldmatrix gives each lane at the kernel's lane addresses, the
16 x 16 softmax in f32 with the probabilities normalised and rounded to bf16,
p v from the probability accumulators as they stand (the A fragment) and v's
fragments from ldmatrix.trans, o rounded once to bf16. Sequences of F != 16
frames (1 <= F <= 24) use MT = 1 row tile up to 16 and MT = 2 above: the
ring copies F rows into tiles of 16 MT rows whose other rows stay zero, keys
past F get -inf before the row max, and only F rows are stored.

The emulation is held against the port's plain version
(``temporal_attention_reference``) and against the JAX package's Pallas
``_kernel`` in interpret mode (``temporal_attention(..., interpret=True)``),
at head dims 40, 80 and 160, at F = 4, 8, 16 and 24, and on q/k/v
pitched inside one fused projection. Tolerance: 2^-6 * max(1, max|plain|), the one the card check
(``chip_smoke.py``) holds the kernel to; the emulation rounds where the
plain version does and differs only in the order of its f32 sums.

The host code and the kernel's limits are mirrored too: shared memory a
warp and a block, warps a block, the banks the row padding spreads, and the
ring's stage schedule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import temporal_attention as j_ta
from latentsync_tpu_torch.ops import temporal_attention as p_ta

TOL_REL = 2.0**-6
BF = torch.bfloat16
TF = 16             # rows of an m16 tile
MAX_F = 24          # frames a sequence, at most
T_WARPS = 4         # warps a block, at most
T_STAGES = 3        # ring stages a warp
SMEM_MAX = 232448   # dynamic shared memory a block may have


# ---------------------------------------------------------------------------
# mirrors of the host code and the layout
# ---------------------------------------------------------------------------


def row_bytes(d: int) -> int:
    """odd_row_bytes (csrc/mma_sync.cuh): D bf16 padded to an odd number of
    16-byte chunks."""
    return ((d // 8) | 1) * 16


def row_tiles(f: int) -> int:
    """MT: m16 row tiles a task (one up to 16 frames, two up to 24)."""
    assert 1 <= f <= MAX_F
    return 1 if f <= TF else 2


def stage_bytes(d: int, mt: int = 1) -> int:
    return 3 * TF * mt * row_bytes(d)


def geometry(d: int, mt: int = 1):
    """temporal_geometry: (warps a block, dynamic shared memory)."""
    per_warp = T_STAGES * stage_bytes(d, mt)
    warps = min(T_WARPS, SMEM_MAX // per_warp)
    return warps, warps * per_warp


def ring_schedule(tasks: int, warps_total: int, warp: int):
    """The (task, stage it lands in, stage its copies start into) of one warp's
    walk: the prologue copies the first T_STAGES - 1 tasks into stages 0, 1;
    at task i the copies of task i + T_STAGES - 1 start into the stage task
    i - 1 used."""
    mine = list(range(warp, tasks, warps_total))
    return [(t, i % T_STAGES, (i - 1) % T_STAGES) for i, t in enumerate(mine)]


# lane addresses the kernel gives ldmatrix: (row, column) of each lane's row
def _a_addr(lane: int):
    return (lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8


def _b_addr(lane: int):
    return (lane & 7) + (lane >> 4) * 8, ((lane >> 3) & 1) * 8


def ldmatrix(tiles: torch.Tensor, addr, count: int, trans: bool = False) -> torch.Tensor:
    """ldmatrix.sync.m8n8.x{count}[.trans] on (T, rows, cols) tiles: lane
    8j + r points row r of matrix j at addr(lane) = (row, col). Lane 4g + t
    gets, of matrix j, (M[g, 2t], M[g, 2t+1]), or with .trans
    (M[2t, g], M[2t+1, g]). Returns (T, 32, count, 2)."""
    rows = np.zeros((32, count, 2), np.int64)
    cols = np.zeros((32, count, 2), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(count):
            for e in range(2):
                src, off = (8 * j + 2 * t + e, g) if trans else (8 * j + g, 2 * t + e)
                r, c = addr(src)
                rows[lane, j, e], cols[lane, j, e] = r, c + off
    return tiles[:, torch.from_numpy(rows), torch.from_numpy(cols)]


def _scatter(frags: torch.Tensor, places, shape) -> torch.Tensor:
    """The (T, *shape) matrix whose element places(g, t, reg, e) lane 4g + t
    holds in frags[:, lane, reg, e]."""
    out = torch.zeros(frags.shape[0], *shape)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg in range(frags.shape[2]):
            for e in range(2):
                out[:, places(g, t, reg, e)[0], places(g, t, reg, e)[1]] = frags[:, lane, reg, e]
    return out


def mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mma.sync m16n8k16 (a: 4 registers a lane, b: 2) or m16n8k8 (a: 2,
    b: 1), bf16 pairs, f32 products: the (T, 16, 8) product."""
    k = 8 * b.shape[2]
    a_m = _scatter(a, lambda g, t, r, e: ((g + 8 * (r & 1), 2 * t + 8 * (r >> 1) + e)),
                   (16, k))
    b_m = _scatter(b, lambda g, t, r, e: ((2 * t + 8 * r + e, g)), (k, 8))
    return a_m.float() @ b_m.float()


def accumulator_fragments(acc: torch.Tensor) -> torch.Tensor:
    """(T, 16, N) accumulators as the lanes hold them: (T, 32, N / 8 tiles,
    4) = [M[g, 8j+2t], M[g, 8j+2t+1], M[g+8, 8j+2t], M[g+8, 8j+2t+1]]."""
    n = acc.shape[2]
    out = torch.empty(acc.shape[0], 32, n // 8, 4)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(n // 8):
            c = 8 * j + 2 * t
            out[:, lane, j] = torch.stack([acc[:, g, c], acc[:, g, c + 1], acc[:, g + 8, c],
                                           acc[:, g + 8, c + 1]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def core_tasks(qt, kt, vt, scale: float, frames: int = TF) -> torch.Tensor:
    """One warp's work on T tasks at once: (T, 16 MT, D) bf16 tiles (rows
    past `frames` zero) -> bf16 o of the same tile shape."""
    d = qt.shape[2]
    mt = qt.shape[1] // TF
    s = torch.zeros(qt.shape[0], TF * mt, TF * mt)
    for r in range(mt):  # query row tile
        q_r = qt[:, TF * r:TF * (r + 1)]
        for c in range(mt):  # 16-key tile
            k_c = kt[:, TF * c:TF * (c + 1)]
            blk = torch.zeros(qt.shape[0], TF, TF)
            kk = 0
            while kk + 16 <= d:
                a = ldmatrix(q_r, lambda ln: (_a_addr(ln)[0], kk + _a_addr(ln)[1]), 4)
                b = ldmatrix(k_c, lambda ln: (_b_addr(ln)[0], kk + _b_addr(ln)[1]), 4)
                blk[:, :, :8] += mma(a, b[:, :, 0:2])
                blk[:, :, 8:] += mma(a, b[:, :, 2:4])
                kk += 16
            if kk < d:  # D % 16 == 8: the m16n8k8 step (x2 loads: lanes 0-15 address rows 0-15)
                a = ldmatrix(q_r, lambda ln: (ln & 15, kk), 2)
                b = ldmatrix(k_c, lambda ln: (ln & 15, kk), 2)
                blk[:, :, :8] += mma(a, b[:, :, 0:1])
                blk[:, :, 8:] += mma(a, b[:, :, 1:2])
            s[:, TF * r:TF * (r + 1), TF * c:TF * (c + 1)] = blk
    s = s * scale
    s[:, :, frames:] = -torch.inf  # keys past F
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(BF)
    o = torch.zeros(qt.shape[0], TF * mt, d)
    cpr = d // 8
    for r in range(mt):
        o_r = torch.zeros(qt.shape[0], TF, d)
        for c in range(mt):  # 16-key steps of p v
            pf = accumulator_fragments(p[:, TF * r:TF * (r + 1), TF * c:TF * (c + 1)].float())
            # two 8-key tiles: one 16-deep A fragment
            pa = torch.stack([pf[:, :, 0, 0:2], pf[:, :, 0, 2:4], pf[:, :, 1, 0:2],
                              pf[:, :, 1, 2:4]], dim=2)
            v_c = vt[:, TF * c:TF * (c + 1)]
            j = 0
            while j + 2 <= cpr:
                b = ldmatrix(v_c, lambda ln: (_a_addr(ln)[0], 8 * j + _a_addr(ln)[1]), 4,
                             trans=True)
                o_r[:, :, 8 * j:8 * j + 8] += mma(pa, b[:, :, 0:2])
                o_r[:, :, 8 * j + 8:8 * j + 16] += mma(pa, b[:, :, 2:4])
                j += 2
            if j < cpr:
                b = ldmatrix(v_c, lambda ln: (_a_addr(ln)[0], 8 * j), 2, trans=True)
                o_r[:, :, 8 * j:8 * j + 8] += mma(pa, b)
        o[:, TF * r:TF * (r + 1)] = o_r
    return o.to(BF)


def emulate_temporal_core(q, k, v, heads: int, scale=None) -> torch.Tensor:
    """(B, F, heads * D) each (any row pitch) -> (B, F, heads * D) bf16:
    every (sequence, head) task's tiles as the ring holds them (F rows
    copied into 16 MT, the rest zero), and the F rows the kernel stores."""
    b, f, hd = q.shape
    d = hd // heads
    mt = row_tiles(f)
    scale = d ** -0.5 if scale is None else scale
    tiles = []
    for t in (q, k, v):
        tile = torch.zeros(b * heads, TF * mt, d, dtype=BF)
        tile[:, :f] = t.reshape(b, f, heads, d).permute(0, 2, 1, 3).reshape(b * heads, f, d)
        tiles.append(tile)
    o = core_tasks(*tiles, scale, f)[:, :f]  # task b * heads + h
    return o.reshape(b, heads, f, d).permute(0, 2, 1, 3).reshape(b, f, hd)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _r(rng, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(BF)


def _qkv(seed, b, hd, sliced, s=1.0, f=TF):
    rng = np.random.default_rng(seed)
    if sliced:  # column slices of one (rows, 3 * inner) projection: row pitch 3 * inner
        qkv = _r(rng, b, f, 3 * hd, s=s)
        return qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    return tuple(_r(rng, b, f, hd, s=s) for _ in range(3))


def _within(got, plain):
    got, plain = np.asarray(got, np.float32), np.asarray(plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


@pytest.mark.parametrize("b,heads,d,sliced", [
    (2, 8, 40, False),   # int8-dense's C = 320 block: k16, k16, k8; five 8-column tiles of o
    (2, 8, 80, True),    # C = 640, pitched: five k16 steps, ten tiles
    (2, 8, 160, False),  # the default forward's C = 1280
    (3, 2, 160, True),
    (3, 3, 24, False),   # one k16 step and a k8 tail, three tiles (an odd end)
    (2, 1, 8, False),    # a k8 step alone, one tile
])
def test_temporal_core_emulation_matches_plain_version(b, heads, d, sliced):
    q, k, v = _qkv(b * d + heads, b, heads * d, sliced, s=2.0)
    assert p_ta._rows(q, "q") == (3 if sliced else 1) * heads * d  # the pitch the kernel reads
    got = emulate_temporal_core(q, k, v, heads)
    _within(got.float(), p_ta.temporal_attention_reference(q, k, v, heads).float())


@pytest.mark.parametrize("b,heads,d,sliced", [(4, 8, 40, False), (4, 8, 80, True),
                                              (2, 8, 160, True)])
def test_temporal_core_emulation_matches_the_pallas_kernel(b, heads, d, sliced):
    """The JAX package's Pallas ``_kernel`` in interpret mode (frame-major
    (F, heads) fold, block-diagonal mask), one batch entry a grid step."""
    q, k, v = _qkv(17 * b + d, b, heads * d, sliced, s=2.0)
    got = emulate_temporal_core(q, k, v, heads)
    jb = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    ref = j_ta.temporal_attention(jb(q), jb(k), jb(v), heads, block=1, interpret=True)
    _within(got.float(), np.asarray(jnp.asarray(ref, dtype=jnp.float32)))


@pytest.mark.parametrize("b,heads,d,f,sliced", [
    (3, 8, 40, 4, False),    # one tile, 12 zero rows: keys 4-15 masked
    (2, 8, 80, 8, True),     # pitched
    (2, 8, 160, 24, False),  # two row tiles, keys 24-31 masked
    (3, 3, 24, 24, True),    # the k8 tail and an odd end at MT = 2
    (2, 2, 40, 17, False),   # one frame past a tile
    (4, 1, 8, 1, False),     # a single frame: p = 1
])
def test_temporal_core_emulation_any_frames_matches_plain_version(b, heads, d, f, sliced):
    q, k, v = _qkv(b * d + f, b, heads * d, sliced, s=2.0, f=f)
    got = emulate_temporal_core(q, k, v, heads)
    _within(got.float(), p_ta.temporal_attention_reference(q, k, v, heads).float())


@pytest.mark.parametrize("b,heads,d,f", [(4, 8, 40, 4), (4, 8, 80, 8), (2, 8, 160, 24)])
def test_temporal_core_emulation_any_frames_matches_the_pallas_kernel(b, heads, d, f):
    q, k, v = _qkv(31 * b + d + f, b, heads * d, False, s=2.0, f=f)
    got = emulate_temporal_core(q, k, v, heads)
    jb = lambda t: jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)  # noqa: E731
    ref = j_ta.temporal_attention(jb(q), jb(k), jb(v), heads, block=1, interpret=True)
    _within(got.float(), np.asarray(jnp.asarray(ref, dtype=jnp.float32)))


def test_fragments_give_the_exact_products():
    """With f32 data the fragment walk is exact algebra: q k^T and p v of one
    task equal the plain products (ldmatrix lane addresses, the k8 tail, the
    accumulator-as-A-fragment and the transposed loads all land right)."""
    rng = np.random.default_rng(0)
    for d in (8, 24, 40, 80, 160):
        q, k, v = (torch.from_numpy(rng.standard_normal((1, TF, d)).astype(np.float32))
                   for _ in range(3))
        s = torch.zeros(1, TF, TF)
        kk = 0
        while kk + 16 <= d:
            a = ldmatrix(q, lambda ln: (_a_addr(ln)[0], kk + _a_addr(ln)[1]), 4)
            b = ldmatrix(k, lambda ln: (_b_addr(ln)[0], kk + _b_addr(ln)[1]), 4)
            s[:, :, :8] += mma(a, b[:, :, 0:2])
            s[:, :, 8:] += mma(a, b[:, :, 2:4])
            kk += 16
        if kk < d:
            a = ldmatrix(q, lambda ln: (ln & 15, kk), 2)
            b = ldmatrix(k, lambda ln: (ln & 15, kk), 2)
            s[:, :, :8] += mma(a, b[:, :, 0:1])
            s[:, :, 8:] += mma(a, b[:, :, 1:2])
        torch.testing.assert_close(s, q @ k.transpose(1, 2), rtol=1e-5, atol=1e-5)
        p = torch.softmax(s, -1)
        pf = accumulator_fragments(p)
        pa = torch.stack([pf[:, :, 0, 0:2], pf[:, :, 0, 2:4], pf[:, :, 1, 0:2],
                          pf[:, :, 1, 2:4]], dim=2)
        o = torch.cat([mma(pa, ldmatrix(v, lambda ln: (_a_addr(ln)[0], 8 * j), 2, trans=True))
                       for j in range(d // 8)], dim=2)
        torch.testing.assert_close(o, p @ v, rtol=1e-5, atol=1e-5)


def test_shared_memory_limits_and_banks():
    """Every served head dim gets four warps a block within the block's
    limit (D = 160: 193,536 bytes, one block an SM); a wide head gets fewer
    warps; the eight rows an ldmatrix phase reads start in eight distinct
    16-byte bank groups (row pitch an odd number of chunks)."""
    assert geometry(40) == (4, 4 * 3 * 3840)
    assert geometry(80) == (4, 4 * 3 * 8448)
    assert geometry(160) == (4, 193536)
    assert geometry(256)[0] == 3 and geometry(256)[1] <= SMEM_MAX
    assert geometry(2048)[0] == 0  # the host refuses a head whose one-warp ring does not fit
    # two row tiles (F > 16): twice the ring; D = 160 keeps two warps a block
    assert geometry(40, 2) == (4, 4 * 3 * 7680) and geometry(80, 2) == (4, 4 * 3 * 16896)
    assert geometry(160, 2) == (2, 2 * 3 * 32256)
    assert [row_tiles(f) for f in (1, 16, 17, 24)] == [1, 1, 2, 2]
    for d in (8, 24, 40, 64, 80, 128, 160, 256):
        rb = row_bytes(d)
        assert rb >= 2 * d and (rb // 16) % 2 == 1
        assert len({(r * rb // 16) % 8 for r in range(8)}) == 8, d


def test_ring_schedule_never_overwrites_a_stage_in_use():
    """A warp's walk: task i computes from stage i mod 3, and the copies it
    starts go to the stage task i - 1 left; across the walk every stage is
    refilled only after the task that used it finished (the warp-wide
    barrier at the top of each task)."""
    for tasks, total, warp in ((37, 8, 3), (2048, 528, 0), (5, 8, 6)):
        walk = ring_schedule(tasks, total, warp)
        in_use = {}
        for i, (task, stage, refill) in enumerate(walk):
            assert stage == i % T_STAGES
            if i >= 1:
                assert refill == walk[i - 1][1]  # the stage just left
            in_use[stage] = task
            # the copies started at task i are for task i + 2, whose stage is the refilled one
            if i + 2 < len(walk):
                assert walk[i + 2][1] == refill
