"""The algorithm of the tensor-core attention core, emulated in plain torch.

``csrc/attn_core.cuh`` (K4 ``spatial_attention`` and K11
``oneshot_attention``) cannot run without a card, so its arithmetic is kept
testable here: ``core_online`` and ``core_two_sweeps`` below repeat, tile by
tile, what one warp of the kernel does to its query rows: 64-key tiles,
the head dim zero-padded to the 16-deep MMA step (48 / 80 / 160), keys past
S masked to -inf before the max, logits scaled inside a base-2 exponential
(``2^(s c - m c)``, c = scale * log2 e), f32 running max and sum with the
output rescaled only where a row's max moved, probabilities rounded to bf16
before the value product; and K11's two sweeps (whole-row max and sum
first, then normalised probabilities rounded to bf16).

K5 (``cross_attention_block``) runs the same two sweeps on its audio
context: ``cross_core`` reads q at pitch inner and k, v in place from the
fused ``[k | v]`` projection at pitch 2 * inner, the 50 keys one masked
64-key tile (``csrc/cross_attn_block.cu``).

Each emulation is held against the port's plain version
(``spatial_attention_reference`` / ``oneshot_attention_reference``) and
against the JAX package's Pallas kernel in interpret mode
(``_spatial_kernel`` / ``_oneshot_kernel``), on bf16 inputs made from a
numpy seed, within 2^-6 * max(1, max|plain|): the tolerance the card check
(``chip_smoke.py``) holds the kernels to, about two bf16 ulps at the
output's top binade. The kernels themselves are held to the same plain
versions on the card by ``tests/test_torch_kernels.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsync_tpu.ops import attention as j_attn
from latentsync_tpu.ops import attn_block as j_ab
from latentsync_tpu.ops import temporal_attention as j_ta
from latentsync_tpu_torch.ops import attention as p_attn
from latentsync_tpu_torch.ops import attn_block as p_ab
from latentsync_tpu_torch.ops import temporal_attention as p_ta
from latentsync_tpu_torch.ops.ffn import layer_norm_f32

TOL_REL = 2.0**-6
KT = 64  # keys of one tile
LOG2E = 1.4426950408889634

SEQS = [16, 64, 100, 256]
HEAD_DIMS = [40, 80, 160]


def _tiles(q, k, v, scale):
    """Yield per key tile what the kernel's first product sees: the f32
    logits of all query rows against the tile's 64 keys (raw, unscaled;
    -inf past the keys' end) and the tile's V rows (zero past it).
    q: (S, D), k, v: (Sk, D) bf16; the head dim is zero-padded to the MMA's
    k-step."""
    s_len, d = q.shape
    dp = (d + 15) // 16 * 16
    qp = torch.zeros(s_len, dp)
    qp[:, :d] = q.float()
    for k0 in range(0, k.shape[0], KT):
        rows = min(KT, k.shape[0] - k0)
        kt = torch.zeros(KT, dp)
        vt = torch.zeros(KT, d)
        kt[:rows, :d] = k[k0:k0 + rows].float()
        vt[:rows] = v[k0:k0 + rows].float()
        logits = qp @ kt.t()
        logits[:, rows:] = -math.inf
        yield logits, vt


def core_online(q, k, v, scale):
    """K4's path for one (batch, head): online softmax over the tiles."""
    s_len, d = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((s_len,), -math.inf)
    l = torch.zeros(s_len)
    acc = torch.zeros(s_len, d)
    rescales = 0
    for logits, vt in _tiles(q, k, v, scale):
        x = torch.maximum(m, logits.max(dim=-1).values)
        moved = x != m
        corr = torch.where(moved, torch.exp2((m - x) * c), torch.ones(()))
        rescales += int(moved.sum())
        l = l * corr
        acc = torch.where(moved[:, None], acc * corr[:, None], acc)  # skipped where unmoved
        m = x
        p = torch.exp2(logits * c - (m * c)[:, None])
        l = l + p.sum(dim=-1)
        acc = acc + p.to(torch.bfloat16).float() @ vt
    return (acc / l[:, None]).to(q.dtype), rescales


def core_two_sweeps(q, k, v, scale):
    """K11's path for one (batch, head): statistics of the whole row first,
    then normalised probabilities, rounded, into the value product."""
    s_len, d = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((s_len,), -math.inf)
    l = torch.zeros(s_len)
    for logits, _ in _tiles(q, k, v, scale):  # sweep 1
        x = torch.maximum(m, logits.max(dim=-1).values)
        l = l * torch.where(x != m, torch.exp2((m - x) * c), torch.ones(()))
        m = x
        l = l + torch.exp2(logits * c - (m * c)[:, None]).sum(dim=-1)
    inv = 1.0 / l
    acc = torch.zeros(s_len, d)
    for logits, vt in _tiles(q, k, v, scale):  # sweep 2
        p = torch.exp2(logits * c - (m * c)[:, None]) * inv[:, None]
        acc = acc + p.to(torch.bfloat16).float() @ vt
    return acc.to(q.dtype)


def _inputs(seed, *shape, gain=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * gain).astype(np.float32))
            .to(torch.bfloat16) for _ in range(3)]


def _jnp(t):
    return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.float32))


def _within(got, plain):
    got, plain = np.asarray(got, np.float32), np.asarray(plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", SEQS)
def test_online_core_matches_plain_version_and_pallas_kernel(s, d):
    heads, b = 2, 2
    q, k, v = _inputs(100 * s + d, b, s, heads * d)
    scale = 1.0 / math.sqrt(d)
    got = torch.empty_like(q)
    for i in range(b):
        for h in range(heads):
            sl = slice(h * d, (h + 1) * d)
            got[i, :, sl], _ = core_online(q[i, :, sl], k[i, :, sl], v[i, :, sl], scale)
    _within(got.float().numpy(), p_ta.spatial_attention_reference(q, k, v, heads).float().numpy())
    ref = j_ta.spatial_attention(_jnp(q), _jnp(k), _jnp(v), heads, interpret=True)
    _within(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("s", SEQS)
def test_two_sweep_core_matches_plain_version_and_pallas_kernel(s, d):
    b = 3
    q, k, v = _inputs(200 * s + d, b, s, d)
    scale = 1.0 / math.sqrt(d)
    got = torch.stack([core_two_sweeps(q[i], k[i], v[i], scale) for i in range(b)])
    _within(got.float().numpy(), p_attn.oneshot_attention_reference(q, k, v).float().numpy())
    ref = j_attn.oneshot_attention(_jnp(q), _jnp(k), _jnp(v), interpret=True)
    _within(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("s,d", [(256, 40), (100, 80)])
def test_cores_with_large_logits_against_f64(s, d):
    """Inputs x 30: logits in the thousands, near one-hot rows; the running
    max moves in some tiles and rests in others, and the skipped rescale
    must leave the same sums."""
    q, k, v = _inputs(7, s, d, gain=30.0)
    scale = 1.0 / math.sqrt(d)
    exact = torch.softmax(q.double() @ k.double().t() * scale, -1) @ v.double()
    online, rescales = core_online(q, k, v, scale)
    tiles = -(-s // KT)
    assert s < rescales < s * tiles  # every row moved once, none in every tile
    _within(online.float().numpy(), exact.numpy())
    _within(core_two_sweeps(q, k, v, scale).float().numpy(), exact.numpy())


def test_two_sweeps_round_normalised_probabilities():
    """What makes K11 K11: with bf16 inputs it rounds p / sum, the online
    core rounds p and divides after, so the two differ in places, and each
    stays within tolerance of the other's plain version."""
    q, k, v = _inputs(11, 256, 40)
    scale = 1.0 / math.sqrt(40)
    one = core_two_sweeps(q, k, v, scale)
    online, _ = core_online(q, k, v, scale)
    assert not torch.equal(one, online)
    _within(one.float().numpy(), online.float().numpy())


def test_masked_keys_and_padded_head_dim_add_nothing():
    """S = 100 against the same rows inside a longer zero-padded problem cut
    by hand: the mask, not the data past the end, decides the result."""
    q, k, v = _inputs(12, 100, 40)
    scale = 1.0 / math.sqrt(40)
    got, _ = core_online(q, k, v, scale)
    w = torch.softmax(q.float() @ k.float().t() * scale, -1).to(torch.bfloat16).float()
    _within(got.float().numpy(), (w @ v.float()).numpy())


def test_block_q_is_accepted_and_ignored_by_the_plain_version():
    q, k, v = (t.float() for t in _inputs(13, 2, 64, 80))
    ref = p_ta.spatial_attention(q, k, v, 2)
    for block_q in p_ta.SPATIAL_BLOCK_QS:
        assert torch.equal(p_ta.spatial_attention(q, k, v, 2, block_q=block_q), ref)
    assert [p_ta.spatial_block_q(s) for s in (1, 16, 17, 64, 255, 256, 1024, 1400)] == \
        [64, 64, 64, 64, 64, 128, 128, 128]


# ---------------------------------------------------------------------------
# K5: the audio cross-attention core on the two sweeps
# ---------------------------------------------------------------------------


def cross_core(q, kv, b, s_len, sk, heads, d):
    """K5's core arguments: q (B S, inner) at pitch inner; k = kv and v = kv
    + inner, both at pitch 2 inner, Sk keys a batch entry; the output at
    pitch inner. Each (batch, head) runs ``core_two_sweeps``."""
    inner = heads * d
    assert q.shape == (b * s_len, inner) and kv.shape == (b * sk, 2 * inner)
    flat_kv = kv.reshape(-1)
    o = torch.empty_like(q)
    for i in range(b):
        for h in range(heads):
            cols = slice(h * d, (h + 1) * d)
            # rows of the fused buffer read through the pitch, as the kernel's copies do
            rows = (i * sk + torch.arange(sk))[:, None] * (2 * inner) + h * d + torch.arange(d)
            k, v = flat_kv[rows], flat_kv[rows + inner]
            o[i * s_len:(i + 1) * s_len, cols] = core_two_sweeps(
                q[i * s_len:(i + 1) * s_len, cols], k, v, 1.0 / math.sqrt(d))
    return o


def cross_block(x, ln_w, ln_b, ctx, wq, wk, wv, wo, bo, heads, eps=1e-6):
    """The block around the core as the kernel chain rounds it: bf16 LN(x)
    and q, one bf16 [k | v] product on the raw context, the core, then the
    output projection with bias and residual in f32 and one rounding."""
    dt = x.dtype
    b, s_len, c = x.shape
    sk = ctx.shape[1]
    inner = wq.shape[0]
    h = layer_norm_f32(x, ln_w, ln_b, eps).to(dt).reshape(b * s_len, c)
    q = (h.float() @ wq.float().t()).to(dt)
    kv = (ctx.reshape(b * sk, -1).float() @ torch.cat([wk, wv]).float().t()).to(dt)
    o = cross_core(q, kv, b, s_len, sk, heads, inner // heads)
    out = x.reshape(b * s_len, c).float() + o.float() @ wo.float().t() + bo.float()
    return out.to(dt).reshape(b, s_len, c)


def _cross_args(seed, b, s_len, c, sk=50, cc=384, heads=8):
    rng = np.random.default_rng(seed)

    def r(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(
            torch.bfloat16)

    return (r(b, s_len, c), 1 + r(c, s=0.1), r(c, s=0.1), r(b, sk, cc), r(c, c, s=c**-0.5),
            r(c, cc, s=cc**-0.5), r(c, cc, s=cc**-0.5), r(c, c, s=c**-0.5), r(c, s=0.1), heads)


@pytest.mark.parametrize("c,s_len", [(320, 64), (320, 100), (640, 48)])  # d = 40, 40, 80
def test_cross_core_matches_plain_block_and_pallas_kernel(c, s_len):
    """K5 with its core on the two sweeps over one masked 50-key tile, k and
    v read in place from the fused projection, against the plain block and
    the JAX ``_cross_kernel`` in interpret mode."""
    args = _cross_args(c + s_len, 2, s_len, c)
    x, ln_w, ln_b, ctx, wq, wk, wv, wo, bo, heads = args
    got = cross_block(*args)
    _within(got.float().numpy(), p_ab.cross_attention_block_reference(*args).float().numpy())
    d = c // heads
    ref = j_ab._cross_fused(_jnp(x), _jnp(ctx), jnp.asarray(ln_w.float().numpy()),
                            jnp.asarray(ln_b.float().numpy()), _jnp(wq.t()), _jnp(wk.t()),
                            _jnp(wv.t()), _jnp(wo.t()), jnp.asarray(bo.float().numpy()), heads,
                            1e-6, 1.0 / math.sqrt(d), 1, True)
    _within(got.float().numpy(), _np(ref))


@pytest.mark.parametrize("d", [40, 80])
def test_cross_core_reads_k_and_v_through_the_fused_pitch(d):
    """The core alone, against the plain attention on k and v cut from the
    fused buffer by hand: the pitch 2 * inner and the v offset pick the
    right columns, and the 14 masked keys of the tile add nothing."""
    heads, b, s_len, sk = 3, 2, 70, 50
    inner = heads * d
    q = _inputs(d, b * s_len, inner)[0]
    kv = _inputs(d + 1, b * sk, 2 * inner)[0]
    got = cross_core(q, kv, b, s_len, sk, heads, d)
    k, v = kv[:, :inner].reshape(b, sk, heads, d), kv[:, inner:].reshape(b, sk, heads, d)
    want = p_attn.dot_product_attention_reference(q.reshape(b, s_len, heads, d), k, v)
    _within(got.float().numpy(), want.reshape(b * s_len, inner).float().numpy())
