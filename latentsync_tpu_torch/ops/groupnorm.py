"""GroupNorm (+ SiLU) in one HBM round trip (K6, K7).

Counterpart of ``latentsync_tpu/ops/groupnorm.py``, in the port's
channels-first layout: x is (N, C, *spatial) and each of the N samples
has its own statistics per group of C/G channels, as in
``F.group_norm`` — a 5-D (B, C, F, H, W) input gives the UNet's
cross-frame statistics, the frame-folded (B·F, C, H, W) input its
per-frame statistics. The reference's (rows, C) ``rows_per_sample`` is
the product of the spatial axes here.

- ``group_norm_silu`` (K6): one kernel launch, one block per (sample,
  group) slab (``csrc/groupnorm.cu``);
- ``group_norm_silu_streaming`` (K7): one launch, one thread-block
  cluster per slab, each block holding its part of the slab in registers
  and shared memory (``gn_cluster_blocks`` sizes the cluster); each
  element is read once from device memory;
- ``group_norm_silu_auto``: the reference's routing — K6 when one
  sample's f32 slab is at most 2 MiB, else K7, and the plain version
  where the reference's streaming blocks would not tile the sample.

Each kernel takes bf16 in and gives bf16 out, with f32 statistics,
scale/bias and SiLU. On a CPU tensor each runs the plain version. Neither
kernel has a gradient, here or in the reference (``groupnorm.py:92``,
``:185`` carry no ``custom_vjp``): a launch under grad with an input that
requires grad raises (``_build.refuse_grad``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# the reference's per-block f32 slab budget (groupnorm.py:215)
_SLAB_BUDGET = 2 * 2**20
# K7: a cluster has at most 8 blocks (the portable size), each holding its
# part of the slab; the wrapper aims for parts of at most 64 KB, so that
# smaller slabs leave room for more blocks an SM
_CLUSTER_MAX = 8
_PART_BYTES = 64 * 2**10
# a block of K7 holds its part in up to 226 KB of shared memory, and where
# the spatial size is a multiple of 8 its first 32 KB in registers
# (csrc/groupnorm.cu)
_PART_SMEM_BYTES = 232448 - 1024
_PART_REG_BYTES = 512 * 4 * 16


def group_norm_silu_reference(x: torch.Tensor, scale, bias, groups: int,
                              eps: float = 1e-5, silu: bool = True) -> torch.Tensor:
    """Plain version: f32 statistics (biased variance), scale/bias and SiLU,
    returned in x.dtype."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(bshape) + bias.float().reshape(bshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def gn_route(rows: int, c: int) -> Optional[str]:
    """``group_norm_silu_auto``'s choice for samples of `rows` positions
    and `c` channels: "single" (K6), "streaming" (K7) or None (plain)."""
    if rows * c * 4 <= _SLAB_BUDGET:
        return "single"
    blk = rows
    while blk % 2 == 0 and blk * c * 4 > _SLAB_BUDGET:
        blk //= 2
    if blk * c * 4 > _SLAB_BUDGET or rows % blk:
        return None
    return "streaming"


def gn_cluster_blocks(slab_bytes: int) -> int:
    """Blocks of K7's cluster for a slab of `slab_bytes`: parts of at most
    64 KB, at most 8 blocks."""
    return max(1, min(_CLUSTER_MAX, -(-slab_bytes // _PART_BYTES)))


def _dims(x: torch.Tensor, groups: int, name: str):
    if x.dim() < 3:
        raise ValueError(f"{name}: expected (N, C, *spatial), got {tuple(x.shape)}")
    n, c = x.shape[:2]
    spatial = math.prod(x.shape[2:])
    if c % groups:
        raise ValueError(f"{name}: C={c} is not a multiple of groups={groups}")
    return n, c, spatial


def _launch(name: str, entry: str, x, scale, bias, groups, eps, silu, *extra):
    n, c, spatial = _dims(x, groups, name)
    x = x.contiguous()
    y = torch.empty_like(x)
    _build.refuse_grad(name, x, scale, bias)
    _build.check_cuda(name, x, y)
    f32 = dict(device=x.device, dtype=torch.float32)
    w = scale.to(**f32).contiguous()
    b = bias.to(**f32).contiguous()
    _build.call(entry, x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), n, c, groups,
                spatial, eps, int(silu), *extra, _build.stream(x))
    return y


def group_norm_silu(x: torch.Tensor, scale, bias, groups: int, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """K6: x (N, C, *spatial) → GroupNorm(+SiLU)(x), one launch."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
    y = _launch("group_norm_silu", "ls_group_norm_silu", x, scale, bias, groups, eps, silu)
    group_norm_silu.launches += 1
    return y


def group_norm_silu_streaming(x: torch.Tensor, scale, bias, groups: int, eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """K7: x (N, C, *spatial) → GroupNorm(+SiLU)(x), one cluster a slab."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
    n, c, spatial = _dims(x, groups, "group_norm_silu_streaming")
    slab_bytes = (c // groups) * spatial * x.element_size()
    blocks = gn_cluster_blocks(slab_bytes)
    part_max = _PART_SMEM_BYTES + (_PART_REG_BYTES if spatial % 8 == 0 else 0)
    if -(-slab_bytes // blocks) > part_max or n * groups > 65535:
        raise ValueError(f"group_norm_silu_streaming: no kernel for {n * groups} slabs of "
                         f"{c // groups} x {spatial} (at most 65535 slabs, each held by 8 "
                         f"blocks)")
    y = _launch("group_norm_silu_streaming", "ls_group_norm_silu_streaming", x, scale, bias,
                groups, eps, silu, blocks)
    group_norm_silu_streaming.launches += 1
    return y


def group_norm_silu_auto(x: torch.Tensor, scale, bias, groups: int, eps: float = 1e-5,
                         silu: bool = True) -> torch.Tensor:
    """Route like the reference's ``group_norm_silu_auto``."""
    route = gn_route(math.prod(x.shape[2:]), x.shape[1])
    if route == "single":
        return group_norm_silu(x, scale, bias, groups, eps, silu)
    if route == "streaming":
        return group_norm_silu_streaming(x, scale, bias, groups, eps, silu)
    return group_norm_silu_reference(x, scale, bias, groups, eps, silu)


group_norm_silu.launches = 0
group_norm_silu_streaming.launches = 0
