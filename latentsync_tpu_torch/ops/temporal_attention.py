"""Self-attention cores in the model's (B, S, heads·D) layout (K3, K4).

Counterparts of ``latentsync_tpu/ops/temporal_attention.py``:

- ``temporal_attention``: attention across the F = 16 frames of each
  sequence (``csrc/temporal_attention.cu``);
- ``spatial_attention``: per-head attention over the S tokens of each
  frame, S ≤ ~1400 (``csrc/spatial_attention.cu``).

On a CUDA tensor each launches its hand-written kernel; on a CPU tensor
it runs the plain version. q/k/v may be column slices of one fused
projection: the kernels read rows through a pitch. The fused block of
``attn_block`` runs the same kernels inside its own launch chain, so the
counters here count only the routes on which the reference ran these two
TPU kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .attention import dot_product_attention_reference

TEMPORAL_FRAMES = 16
SPATIAL_HEAD_DIMS = (40, 80, 160)


def temporal_attention_reference(q, k, v, heads: int, scale: Optional[float] = None):
    """Plain version (``_temporal_xla``): f32 logits and softmax."""
    b, f, hd = q.shape
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh = q.reshape(b, f, heads, d)
    kh = k.reshape(b, f, heads, d)
    vh = v.reshape(b, f, heads, d)
    return dot_product_attention_reference(qh, kh, vh, scale).reshape(b, f, hd)


def spatial_attention_reference(q, k, v, heads: int, scale: Optional[float] = None):
    """Plain version (``_spatial_xla``)."""
    b, s, hd = q.shape
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    return dot_product_attention_reference(
        q.reshape(b, s, heads, d), k.reshape(b, s, heads, d),
        v.reshape(b, s, heads, d), scale).reshape(b, s, hd)


def _rows(t: torch.Tensor, name: str) -> int:
    """Row pitch of a (B, S, X) view whose rows are evenly spaced and whose
    last axis is contiguous (a plain tensor or a column slice)."""
    b, s, _ = t.shape
    if t.stride(2) != 1 or t.stride(0) != s * t.stride(1) or t.stride(1) % 8:
        raise ValueError(f"{name}: unsupported strides {t.stride()}")
    return t.stride(1)


def spatial_smem_ok(s: int, d: int) -> bool:
    """K and V of one head must fit the 227 KB of shared memory a block may use."""
    return 2 * s * d * 2 <= 227 * 1024


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, F=16, heads·D) → (B, F, heads·D)."""
    if q.device.type == "cpu":
        return temporal_attention_reference(q, k, v, heads, scale)
    b, f, hd = q.shape
    d = hd // heads
    if f != TEMPORAL_FRAMES or d % 8 or hd != heads * d:
        raise ValueError(f"temporal_attention: needs F=16 and D % 8 == 0, got F={f}, D={d}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _build.check_cuda("temporal_attention", q, k, v, o)
    _build.call("ls_temporal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _rows(q, "q"), _rows(k, "k"), _rows(v, "v"), o.data_ptr(), _rows(o, "o"),
                b, heads, d, scale, _build.stream(q))
    temporal_attention.launches += 1
    return o


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, S, heads·D) → (B, S, heads·D)."""
    if q.device.type == "cpu":
        return spatial_attention_reference(q, k, v, heads, scale)
    b, s, hd = q.shape
    d = hd // heads
    if d not in SPATIAL_HEAD_DIMS or hd != heads * d or not spatial_smem_ok(s, d):
        raise ValueError(f"spatial_attention: no kernel for D={d}, S={s}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _build.check_cuda("spatial_attention", q, k, v, o)
    _build.call("ls_spatial_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _rows(q, "q"), _rows(k, "k"), _rows(v, "v"), o.data_ptr(), _rows(o, "o"),
                b, s, heads, d, scale, _build.stream(q))
    spatial_attention.launches += 1
    return o


temporal_attention.launches = 0
spatial_attention.launches = 0
