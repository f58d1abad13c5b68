"""The arithmetic of K7's cluster kernel, emulated in plain torch.

``csrc/groupnorm.cu``'s ``gn_cluster_kernel`` (``group_norm_silu_streaming``
on the card) cannot run without a card, so what it computes is kept testable
here. ``emulate_gn_cluster`` repeats its split and merge: each (sample,
group) slab goes to a cluster of ``gn_cluster_blocks`` blocks, block r
holding elements [r * chunk, (r + 1) * chunk) (chunk rounded up to 8, the
last part shorter; its first 32 KB in registers, the rest in shared
memory); each block's threads take every 512th vector of 8 (every 512th
element where the spatial size is no multiple of 8 and the whole part lies
in shared memory), sum about the part's first element and turn the sums
into (count, mean, M2);
the block merges its threads' moments by Chan's formula, and every block
merges the cluster's block moments in rank order; each block then
normalises its part as x * a + (b - mean * a) with SiLU as h + h tanh(h),
h = y / 2.

The emulation is held against the port's plain version
(``group_norm_silu_reference``) at slabs split over 1 to 8 blocks, ragged
last parts included, and against the JAX package's streaming Pallas kernel
in interpret mode (channels-last rows). Tolerance: 2^-6 * max(1,
max|plain|), the one the card check (``chip_smoke.py``) holds the kernel to
(another summation order and bf16 output). A slab whose mean is far from
zero checks that the shifted sums keep the variance exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latentsync_tpu.ops import groupnorm as j_gn
from latentsync_tpu_torch.ops import groupnorm as p_gn

TOL_REL = 2.0**-6
BF = torch.bfloat16
THREADS = 512       # threads of a block
HEAD = THREADS * 4 * 8    # elements of a part held in registers
SMEM_MAX = 232448 - 1024  # dynamic shared memory of one block

# every slab shape K7 gets in a fused forward at batch 4 (chip_smoke.py
# GN_STREAMING): (C, *spatial) at 32 groups
SERVED = [(c, 16, 32, 32) for c in (960, 640, 320)] \
    + [(c, 16, 16, 16) for c in (1920, 1280, 960, 640, 320)] \
    + [(c, 16, 8, 8) for c in (2560, 1920, 1280, 640)] + [(2560, 16, 4, 4)]


def split(slab_len: int, blocks: int):
    """The host's chunk (ceil(len / blocks) rounded up to 8) and each rank's
    [begin, end)."""
    chunk = -(-(-(-slab_len // blocks)) // 8) * 8
    return chunk, [(min(r * chunk, slab_len), min((r + 1) * chunk, slab_len))
                   for r in range(blocks)]


def merge(a, b):
    """Chan's formula on (n, mean, m2) columns, f32, as the kernel's merge."""
    n = a[0] + b[0]
    safe = torch.where(n > 0, n, torch.ones_like(n))
    delta = b[1] - a[1]
    f = b[0] / safe
    out = (n, a[1] + delta * f, a[2] + b[2] + delta * delta * a[0] * f)
    return tuple(torch.where(b[0] == 0, x, torch.where(a[0] == 0, y, z))
                 for x, y, z in zip(a, b, out))


def block_moments(part: torch.Tensor, vec: int = 8):
    """(slabs, n) f32 part -> the block's (n, mean, m2): each thread's sums
    about the part's first element over its vectors of `vec` elements,
    Chan-merged over the threads."""
    slabs, n = part.shape
    zero = torch.zeros(slabs)
    acc = (zero, zero, zero)
    if n == 0:
        return acc
    shift = part[:, :1]
    vecs = (part - shift).reshape(slabs, n // vec, vec)
    for t in range(min(THREADS, n // vec)):
        mine = vecs[:, t::THREADS].reshape(slabs, -1)
        cnt = float(mine.shape[1])
        s1, s2 = mine.sum(1), (mine * mine).sum(1)
        mean = s1 / cnt
        acc = merge(acc, (torch.full((slabs,), cnt), shift[:, 0] + mean,
                          torch.clamp(s2 - s1 * mean, min=0.0)))
    return acc


def emulate_gn_cluster(x, scale, bias, groups, eps=1e-5, silu=True):
    n, c = x.shape[:2]
    cg = c // groups
    slabs = x.float().reshape(n * groups, -1)
    spatial = slabs.shape[1] // cg
    vec = 8 if spatial % 8 == 0 else 1  # 16-byte vectors, or element loads
    blocks = p_gn.gn_cluster_blocks(slabs.shape[1] * x.element_size())
    _, parts = split(slabs.shape[1], blocks)
    zero = torch.zeros(n * groups)
    total = (zero, zero, zero)
    for begin, end in parts:  # rank order, in every block alike
        total = merge(total, block_moments(slabs[:, begin:end], vec))
    rstd = torch.rsqrt(total[2] / total[0] + eps)
    ch = torch.arange(n * groups) % groups * cg
    w = scale.float()[ch[:, None] + torch.arange(cg)]  # (slabs, cg)
    a = w * rstd[:, None]
    shift = bias.float()[ch[:, None] + torch.arange(cg)] - total[1][:, None] * a
    y = slabs.reshape(-1, cg, spatial) * a[..., None] + shift[..., None]
    if silu:
        h = 0.5 * y
        y = h + h * torch.tanh(h)
    return y.reshape(x.shape).to(x.dtype)


def _r(rng, *shape, s=1.0, o=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * s + o).astype(np.float32)).to(BF)


def _within(got, plain):
    got, plain = np.asarray(got, np.float32), np.asarray(plain, np.float32)
    assert got.shape == plain.shape and np.isfinite(got).all()
    err = float(np.abs(got - plain).max())
    assert err <= TOL_REL * max(1.0, float(np.abs(plain).max())), err


@pytest.mark.parametrize("shape,groups,blocks", [
    ((1, 64, 16, 32, 32), 2, 8),   # 1 MB slabs: 8 blocks of 128 KB, as the served 983 KB
    ((1, 10, 20008), 2, 4),        # 200 KB: 4 parts, the last 24 elements short
    ((2, 40, 16, 16, 16), 4, 2),   # 80 KB: 2 blocks
    ((3, 64, 5, 8), 32, 1),        # one block a slab
    ((2, 96, 3, 8, 8), 32, 1),     # C / G = 3 channels of 192
    # spatial sizes no multiple of 8 (element loads): one block a slab, and
    # 4 parts of 25000 elements, the last 10 short
    ((3, 64, 5, 7), 32, 1),
    ((1, 20, 9999), 2, 4),
])
def test_gn_cluster_emulation_matches_plain_version(shape, groups, blocks):
    rng = np.random.default_rng(sum(shape))
    c = shape[1]
    x = _r(rng, *shape, s=2.0, o=0.5)
    scale, bias = 1 + _r(rng, c, s=0.1), _r(rng, c, s=0.1)
    slab_bytes = (c // groups) * int(np.prod(shape[2:])) * 2
    assert p_gn.gn_cluster_blocks(slab_bytes) == blocks
    for silu in (True, False):
        _within(emulate_gn_cluster(x, scale, bias, groups, silu=silu).float(),
                p_gn.group_norm_silu_reference(x, scale, bias, groups, silu=silu).float())


@pytest.mark.parametrize("f,hw", [(4, 8), (16, 4)])
def test_gn_cluster_emulation_matches_the_pallas_kernel(f, hw):
    """The JAX package's two-phase streaming kernel in interpret mode, on
    channels-last rows (rows = F H W a sample, two row blocks a sample)."""
    rng = np.random.default_rng(f * hw)
    n, c, groups = 2, 64, 32
    x = _r(rng, n, c, f, hw, hw, s=2.0, o=0.5)
    scale, bias = 1 + _r(rng, c, s=0.1), _r(rng, c, s=0.1)
    got = emulate_gn_cluster(x, scale, bias, groups)
    rows = f * hw * hw
    xr = x.float().permute(0, 2, 3, 4, 1).reshape(n * rows, c).numpy()
    ref = j_gn.group_norm_silu_streaming(
        jnp.asarray(xr, dtype=jnp.bfloat16), jnp.asarray(scale.float().numpy()),
        jnp.asarray(bias.float().numpy()), groups, rows, eps=1e-5, silu=True,
        block_rows=rows // 2, interpret=True)
    ref = np.asarray(jnp.asarray(ref, dtype=jnp.float32)).reshape(n, f, hw, hw, c)
    _within(got.float().permute(0, 2, 3, 4, 1).numpy(), ref)


def test_shifted_sums_keep_the_variance_of_an_offset_slab():
    """Values 1000 + 8 N(0, 1) in bf16 (steps of 4 at 1000): the block
    moments from sums about the first element, merged in rank order over 8
    blocks, give the float64 variance to 1e-4."""
    rng = np.random.default_rng(3)
    x = _r(rng, 1, 32768 * 8, s=8.0, o=1000.0)  # one slab of 512 KB
    blocks = p_gn.gn_cluster_blocks(x.numel() * 2)
    assert blocks == 8
    _, parts = split(x.numel(), blocks)
    zero = torch.zeros(1)
    total = (zero, zero, zero)
    for begin, end in parts:
        total = merge(total, block_moments(x.float()[:, begin:end]))
    exact = x.double().flatten()
    assert abs(float(total[1]) - float(exact.mean())) < 1e-3
    var = float(total[2] / total[0])
    assert abs(var / float(exact.var(unbiased=False)) - 1) < 1e-4


def test_cluster_sizes_at_the_served_shapes():
    """Every served slab fits a cluster of at most 8 blocks: 8 blocks of up to
    123 KB at 32^2 latents (32 KB of it in registers, so that two blocks fit
    an SM's 228 KB of shared memory), fewer for smaller slabs; the wrapper's
    limits (spatial a multiple of 8) hold at all 14 shapes."""
    got = {}
    for c, *sp in SERVED:
        slab = c // 32 * int(np.prod(sp))
        blocks = p_gn.gn_cluster_blocks(slab * 2)
        chunk, parts = split(slab, blocks)
        assert 1 <= blocks <= 8 and chunk % 8 == 0 and parts[-1][1] == slab
        assert all(e > b for b, e in parts)  # no empty part
        smem = max(chunk - HEAD, 0) * 2 + (c // 32) * 8  # the rest of the part, coefficients
        assert smem <= SMEM_MAX and 2 * (smem + 1024) <= 228 * 1024  # two blocks an SM
        assert int(np.prod(sp)) % 8 == 0
        got[(c, *sp)] = blocks
    assert got[(960, 16, 32, 32)] == 8 and split(491520, 8)[0] * 2 == 122880
    assert got[(2560, 16, 4, 4)] == 1
