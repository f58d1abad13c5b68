"""The tilings of the flash route and of K12 on the attention core, emulated
in plain torch.

``csrc/attn_core.cuh`` cannot run without a card, so what a block of it does
for ``dot_product_attention``'s flash route (``csrc/flash_attention.cu``) and
for K12 ``flash_attention`` (``csrc/flash_kernel.cu``) is repeated here tile
by tile:

- ``rows_tiling``: head dims 40, 64, 80 and 128. 64-key tiles, the head dim
  zero-padded to the 16-deep MMA step, query and key lengths apart; at
  D = 64 and 128 the K and V tiles lie in the 128-byte swizzle, whose
  addresses (the loads' and the matrix unit's) are mirrored byte for byte
  in ``swizzled_tile_reads``;
- ``columns_tiling``: head dim 512. A block owns 64 query rows and walks
  32-key tiles; each of its two warpgroups computes the tile's whole logits
  and its own softmax and multiplies by ITS 256 columns of V, so the output
  is two column halves side by side.

Both share the kernel's softmax: logits scaled inside a base-2 exponential
(``2^(s c - m c)``, c = scale * log2 e), f32 running max and sum, the output
rescaled only where a row's max moved; and both run in its two numerics:
probabilities rounded to bf16 before the value product (the flash route), or
never rounded (K12): each f32 probability is split into three bf16 terms
whose sum is the probability exactly, the value product runs once a term,
and the row sum is taken from the f32 probabilities.

Each emulation is held against the port's plain version and against the JAX
package (``dot_product_attention`` on its plain CPU path; the Pallas
``_flash_kernel`` through ``pl.pallas_call(..., interpret=True)``), on bf16
inputs made from a numpy seed, within 2^-6 * max(1, max|plain|): the
tolerance the card check (``chip_smoke.py``) holds the kernels to, about two
bf16 ulps at the output's top binade. The kernels themselves are held to the
same plain versions on the card by ``tests/test_torch_kernels.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from latentsync_tpu.ops import attention as j_attn
from latentsync_tpu_torch.ops import attention as p_attn

TOL_REL = 2.0**-6
LOG2E = 1.4426950408889634
ROWS_KT = 64     # keys of one tile of the row tiling
COLUMNS_KT = 32  # of the column-split tiling
COLUMNS_BQ = 64  # query rows of one of its blocks


def split3(p):
    """An f32 tensor as three bf16 terms (held in f32): each the bf16
    rounding of what the terms before left."""
    terms, rem = [], p
    for _ in range(3):
        h = rem.to(torch.bfloat16).float()
        terms.append(h)
        rem = rem - h
    return terms


def online_softmax(q, k, v, scale, kt, unrounded):
    """What one warpgroup does for its query rows q (Sq, D) against all keys
    k (Sk, D) and ITS columns of V, v (Sk, N): the running softmax over
    tiles of kt keys. Returns (output in f32, row max, row sum, rescales)."""
    sq, d = q.shape
    sk = k.shape[0]
    assert sk % kt == 0  # the kernels take whole tiles here
    dp = (d + 15) // 16 * 16
    qp = torch.zeros(sq, dp)
    qp[:, :d] = q.float()
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((sq,), -math.inf)
    l = torch.zeros(sq)
    acc = torch.zeros(sq, v.shape[1])
    rescales = 0
    for k0 in range(0, sk, kt):
        ktile = torch.zeros(kt, dp)
        ktile[:, :d] = k[k0:k0 + kt].float()
        vtile = v[k0:k0 + kt].float()
        logits = qp @ ktile.t()
        x = torch.maximum(m, logits.max(dim=-1).values)
        moved = x != m
        corr = torch.where(moved, torch.exp2((m - x) * c), torch.ones(()))
        rescales += int(moved.sum())
        l = l * corr
        acc = torch.where(moved[:, None], acc * corr[:, None], acc)  # skipped where unmoved
        m = x
        p = torch.exp2(logits * c - (m * c)[:, None])
        l = l + p.sum(dim=-1)  # from the f32 probabilities in both numerics
        for term in (split3(p) if unrounded else [p.to(torch.bfloat16).float()]):
            acc = acc + term @ vtile
    return acc / l[:, None], m, l, rescales


def rows_tiling(q, k, v, scale, unrounded=False):
    """D = 40 / 80 / 128 for one (batch, head)."""
    out, _, _, rescales = online_softmax(q, k, v, scale, ROWS_KT, unrounded)
    return out.to(q.dtype), rescales


def columns_tiling(q, k, v, scale, unrounded=False):
    """D = 512 for one (batch, head): blocks of 64 query rows, two column
    halves a block, each from its own copy of the same logits."""
    sq, d = q.shape
    assert sq % COLUMNS_BQ == 0 and d % 2 == 0
    out = torch.empty(sq, d)
    for r0 in range(0, sq, COLUMNS_BQ):
        rows = slice(r0, r0 + COLUMNS_BQ)
        stats = []
        for half in range(2):
            cols = slice(half * d // 2, (half + 1) * d // 2)
            o, m, l, _ = online_softmax(q[rows], k, v[:, cols], scale, COLUMNS_KT, unrounded)
            out[rows, cols] = o
            stats.append((m, l))
        # the two warpgroups hold the same row statistics without exchanging them
        assert torch.equal(stats[0][0], stats[1][0]) and torch.equal(stats[0][1], stats[1][1])
    return out.to(q.dtype)


def sw128_offset(r, c):
    """Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
    (``csrc/wgmma.cuh``)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def sw128_read(smem, addr):
    """The bf16 element the matrix unit reads at linear byte address `addr`
    of an operand in the 128-byte swizzle (base 1024-byte aligned): bits
    4-6 of the address XOR bits 7-9."""
    phys = addr ^ (((addr >> 7) & 7) << 4)
    return smem[phys // 2]


def swizzled_tile_reads(d, nwg, kt=ROWS_KT):
    """The row tiling's K and V tiles in the 128-byte swizzle, as
    ``csrc/attn_core.cuh``'s ``attn_kernel`` stores and reads them: each of
    its 128 * nwg threads copies 16-byte chunk ``tid % 8`` of every row
    ``tid / 8 + j * RP`` of every 64-column atom, RP = threads / 8 rows a
    pass, to ``sw128_offset(row, chunk) + atom * ATOM``; then the first
    product's descriptor reads k-step kk of K (keys x 16 of d, K-major)
    from ``Tile::k_step(kk)`` on, and the second product's reads k-step j of
    V (16 keys x d, MN-major, the next 64 of d an atom on) from
    ``Tile::v_step(j)`` on. Returns the element ids each read saw, as
    (K's k-steps, V's k-steps), from tiles whose element (row, col) holds
    the id row * d + col."""
    assert d % 64 == 0
    threads, tpr = 128 * nwg, 8
    rp = threads // tpr
    assert kt % rp == 0 and rp % 8 == 0  # the kernel's static_assert (!SW || RP % 8 == 0)
    atom = kt * 128
    k_bytes = v_bytes = kt * d * 2
    smem = np.full((k_bytes + v_bytes) // 2, -1, np.int64)
    ids = np.arange(kt * d).reshape(kt, d)
    for tid in range(threads):
        lr, lc = tid // tpr, tid % tpr
        for j in range(kt // rp):
            r = lr + j * rp
            for a in range(d // 64):
                at = a * atom + j * rp * 128
                dst = sw128_offset(lr, lc) + at
                for base, tile in ((0, ids), (k_bytes, ids)):
                    smem[(base + dst) // 2:(base + dst) // 2 + 8] = tile[r, a * 64 + lc * 8:
                                                                         a * 64 + lc * 8 + 8]
    assert (smem >= 0).all()

    def k_step(kk):
        return kk // 4 * atom + kk % 4 * 32

    def v_step(j):
        return j * 2048

    ks = [np.array([[sw128_read(smem, k_step(kk) + n * 128 + c * 2) for c in range(16)]
                    for n in range(kt)]) for kk in range(d // 16)]
    vs = [np.array([[sw128_read(smem, (k_bytes + v_step(j) + (n // 64) * atom + kr * 128
                                       + (n % 64) * 2)) for n in range(d)]
                    for kr in range(16)]) for j in range(kt // 16)]
    return ks, vs, ids


def tiling_for(d):
    return columns_tiling if d == 512 else lambda *a, **kw: rows_tiling(*a, **kw)[0]


def _inputs(seed, *shapes, gain=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * gain).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _jnp(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.float32))


def _within(got, plain):
    got, plain = np.asarray(got, np.float32), np.asarray(plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


# ---------------------------------------------------------------------------
# the flash route: probabilities rounded to bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [40, 64, 80, 512])
@pytest.mark.parametrize("h", [1, 8])
@pytest.mark.parametrize("s", [256, 384])
def test_rounded_tilings_match_plain_version_and_jax(s, h, d):
    b = 2 if d < 512 else 1
    q, k, v = _inputs(1000 * s + 10 * d + h, *[(b, s, h, d)] * 3)
    assert p_attn.flash_route(q, k)
    scale = 1.0 / math.sqrt(d)
    got = torch.empty_like(q)
    for i in range(b):
        for j in range(h):
            got[i, :, j] = tiling_for(d)(q[i, :, j], k[i, :, j], v[i, :, j], scale)
    _within(got.float().numpy(),
            p_attn.dot_product_attention_reference(q, k, v).float().numpy())
    _within(got.float().numpy(), _np(j_attn.dot_product_attention(_jnp(q), _jnp(k), _jnp(v))))


# ---------------------------------------------------------------------------
# K12: probabilities never rounded
# ---------------------------------------------------------------------------


def _pallas_flash_kernel(q, k, v, scale, bq, bk):
    """The JAX package's kernel body through its own BlockSpecs, interpreted
    (its entry point reaches ``pl.pallas_call`` without an interpret switch)."""
    b, sq, d = q.shape
    sk = k.shape[1]
    return pl.pallas_call(
        functools.partial(j_attn._flash_kernel, scale=scale, kv_len=sk, block_k=bk),
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        grid=(b, sq // bq),
        in_specs=[pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((1, sk, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, sk, d), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
        interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 512), (512, 256)])
def test_unrounded_tilings_match_plain_version_and_pallas_kernel(sq, sk, d):
    b, bq, bk = 2, 256, 256
    q, k, v = _inputs(7 * sq + sk + d, (b, sq, d), (b, sk, d), (b, sk, d))
    assert p_attn.flash_tiles(sq, sk, d, bq, bk)
    scale = 1.0 / math.sqrt(d)
    got = torch.stack([tiling_for(d)(q[i], k[i], v[i], scale, unrounded=True)
                       for i in range(b)])
    _within(got.float().numpy(), p_attn.flash_attention_reference(q, k, v).float().numpy())
    ref = _pallas_flash_kernel(_jnp(q), _jnp(k), _jnp(v), scale, bq, bk)
    _within(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("d", [128, 512])
def test_unrounded_tilings_are_within_one_output_ulp_of_f64(d):
    """What the card test holds K12 to: nothing but the bf16 output is
    rounded, so every element is within one bf16 ulp (2^-8 relative) of an
    f64 attention, plus 1e-5 where the output cancels to near zero."""
    q, k, v = _inputs(31 + d, *[(256, d)] * 3)
    scale = 1.0 / math.sqrt(d)
    exact = torch.softmax(q.double() @ k.double().t() * scale, -1) @ v.double()
    got = tiling_for(d)(q, k, v, scale, unrounded=True)
    assert bool(((got.double() - exact).abs() <= 2.0**-8 * exact.abs() + 1e-5).all())
    # and the rounded numerics are a different function of the same inputs
    assert not torch.equal(got, tiling_for(d)(q, k, v, scale))


def test_three_term_split_is_exact():
    """p0 + p1 + p2 == p bit for bit in f32, each term a bf16 value, for
    probabilities from 1 down to the subnormal edge: wherever the smallest
    term (2^-16 of p) is still a normal number, i.e. p >= 2^-110; for exact
    powers of two and for values one ulp either side of a bf16 rounding
    boundary. Below that edge a term may be flushed to zero, and the sum is
    off by less than the smallest normal number (2^-126 of a row maximum
    of 1)."""
    rng = np.random.default_rng(5)
    mant = rng.uniform(1.0, 2.0, 4096).astype(np.float32)
    p = np.ldexp(mant, rng.integers(-110, 1, 4096)).astype(np.float32)
    edge = np.float32(1.0) + np.float32(2.0**-8)  # halfway between two bf16 values
    p = np.concatenate([p, np.ldexp(np.float32(1.0), np.arange(-126, 1)).astype(np.float32),
                        [edge, np.nextafter(edge, np.float32(0)), np.nextafter(edge, np.float32(2)),
                         np.float32(2.0**-110), np.float32(0.0), np.float32(1.0)]])
    p = p.astype(np.float32)
    t = torch.from_numpy(p)
    p0, p1, p2 = split3(t)
    for term in (p0, p1, p2):
        assert torch.equal(term.to(torch.bfloat16).float(), term)  # a bf16 value
    assert torch.equal((p0 + p1) + p2, t)
    assert bool((p1 != 0).any()) and bool((p2 != 0).any())
    assert bool((p0.abs() >= p1.abs()).all()) and bool((p1.abs() >= p2.abs()).all())
    tiny = torch.from_numpy(np.ldexp(mant, rng.integers(-149, -110, 4096)).astype(np.float32))
    q0, q1, q2 = split3(tiny)
    assert float(((q0 + q1) + q2 - tiny).abs().max()) < 2.0**-126


# ---------------------------------------------------------------------------
# what the tilings share
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("unrounded", [False, True])
@pytest.mark.parametrize("s,d", [(256, 40), (256, 128), (128, 512)])
def test_tilings_with_large_logits_against_f64(s, d, unrounded):
    """Inputs x 30: logits in the thousands, near one-hot rows; the running
    max moves in some tiles and rests in others, and the skipped rescale
    must leave the same sums."""
    q, k, v = _inputs(7 + d, *[(s, d)] * 3, gain=30.0)
    scale = 1.0 / math.sqrt(d)
    exact = torch.softmax(q.double() @ k.double().t() * scale, -1) @ v.double()
    _within(tiling_for(d)(q, k, v, scale, unrounded=unrounded).float().numpy(), exact.numpy())
    kt = COLUMNS_KT if d == 512 else ROWS_KT
    _, _, _, rescales = online_softmax(q, k, v, scale, kt, unrounded)
    assert s < rescales < s * (s // kt)  # every row moved once, none in every tile


@pytest.mark.parametrize("unrounded", [False, True])
def test_column_halves_concatenate_to_the_whole(unrounded):
    """The two warpgroups' halves side by side are the output of one softmax
    over the same 32-key tiles with all 512 columns of V."""
    q, k, v = _inputs(3, *[(128, 512)] * 3)
    scale = 1.0 / math.sqrt(512)
    whole = torch.cat([online_softmax(q[r:r + COLUMNS_BQ], k, v, scale, COLUMNS_KT,
                                      unrounded)[0] for r in (0, 64)]).to(q.dtype)
    halves = columns_tiling(q, k, v, scale, unrounded)
    np.testing.assert_allclose(halves.float().numpy(), whole.float().numpy(), rtol=2.0**-7, atol=0)
    # and the key tile's size is not in the result beyond rounding
    _within(halves.float().numpy(), rows_tiling(q, k, v, scale, unrounded)[0].float().numpy())


def test_query_and_key_lengths_apart_on_the_row_tiling():
    """Keys longer and shorter than the queries: tiles from the keys, rows
    from the queries."""
    for sq, sk in ((64, 192), (192, 64)):
        q, k, v = _inputs(sq, (sq, 128), (sk, 128), (sk, 128))
        got, _ = rows_tiling(q, k, v, 128**-0.5, unrounded=True)
        _within(got.float().numpy(),
                p_attn.flash_attention_reference(q[None], k[None], v[None])[0].float().numpy())


def test_wrapper_checks_reach_the_cpu():
    """What the wrappers decide in Python holds without a card: the views the
    flash route reads in place, and the ones it refuses."""
    qkv = torch.zeros(3, 256, 3 * 320, dtype=torch.bfloat16)
    q = qkv[..., :320].reshape(3, 256, 8, 40)
    assert p_attn._row_pitch(q, "q") == 960
    assert p_attn._row_pitch(torch.zeros(2, 256, 1, 512, dtype=torch.bfloat16), "q") == 512
    for bad in (torch.zeros(6, 256, 8, 40)[::2], torch.zeros(3, 256, 8, 80)[..., ::2],
                torch.zeros(3, 256, 8, 80)[..., :40], torch.zeros(3, 256, 8, 44)[..., :40]):
        with pytest.raises(ValueError, match="strides"):
            p_attn._row_pitch(bad, "q")
    assert p_attn.flash_tiles(1024, 1024, 512, 256, 256)
    assert not p_attn.flash_tiles(128, 128, 128, 256, 256)


@pytest.mark.parametrize("nwg", [1, 2])
@pytest.mark.parametrize("d", [64, 128])
def test_swizzled_tiles_read_back_as_the_products_operands(d, nwg):
    """At D = 64 a K or V row is exactly one 128-byte atom (the first head
    dim of the flash route on the swizzled branch; D = 128, K12's, is two):
    what the loads store and the descriptors read must be K's 16 columns of
    each k-step and V's 16 rows of each, for one warpgroup's 64 query rows
    and for two (``pick_block_q(256)`` = 128 rows, CodeFormer's S)."""
    ks, vs, ids = swizzled_tile_reads(d, nwg)
    for kk, got in enumerate(ks):
        np.testing.assert_array_equal(got, ids[:, 16 * kk:16 * kk + 16])
    for j, got in enumerate(vs):
        np.testing.assert_array_equal(got, ids[16 * j:16 * j + 16, :])


def test_flash_route_at_64_under_grad_is_the_plain_autograd_on_the_cpu():
    """D = 64 has a forward kernel and no backward one: on a CPU tensor the
    route's Function saves q, k, v and differentiates the plain version, so
    CodeFormer's gradients on the CPU are the plain attention's."""
    q, k, v = (t.float().requires_grad_(True) for t in _inputs(64, *[(2, 256, 8, 64)] * 3))
    assert p_attn.flash_route(q, k) and 64 in p_attn.FLASH_FWD_HEAD_DIMS
    assert 64 not in p_attn.FLASH_BWD_HEAD_DIMS
    out = p_attn.dot_product_attention(q, k, v)
    grad = torch.from_numpy(np.random.default_rng(3).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), grad)
    ref = p_attn.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), grad,
                                               64**-0.5)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
