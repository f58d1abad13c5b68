"""Self-attention cores in the model's (B, S, heads·D) layout (K3, K4).

Counterparts of ``latentsync_tpu/ops/temporal_attention.py``:

- ``temporal_attention``: attention across the F frames of each
  sequence, 1 <= F <= 24 (``csrc/temporal_attention.cu``);
- ``spatial_attention``: per-head attention over the S tokens of each
  frame, any S ≥ 1, head dims 40, 80 and 160
  (``csrc/spatial_attention.cu`` on the ``wgmma`` core of
  ``csrc/attn_core.cuh``).

On a CUDA tensor each launches its hand-written kernel; on a CPU tensor
it runs the plain version. Either way each differentiates as the
reference's ``custom_vjp`` does (``temporal_attention.py:115-125``,
``:225-235``): the backward recomputes the composed core and takes its
gradient (``ops/autograd.py``) — ``_temporal_xla`` (the plain version)
for K3, and for K4 ``_spatial_xla``, the routed
``attention.dot_product_attention``, which at S ≥ 256 (S a multiple of
128) is the flash route with its backward kernel. q/k/v may be column slices of one fused
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
from .attention import dot_product_attention, dot_product_attention_reference
from .autograd import with_composed_grad

# frames of a sequence the temporal kernels take, at most (two m16 row tiles;
# the motion modules' positional encoding has 24 rows)
TEMPORAL_MAX_FRAMES = 24
SPATIAL_HEAD_DIMS = (40, 80, 160)
# query rows a block of the spatial kernel can own (a warpgroup owns 64)
SPATIAL_BLOCK_QS = (64, 128)


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


def spatial_block_q(s: int) -> int:
    """The query rows a block that the kernel picks for sequence length `s`
    (``pick_block_q`` in ``csrc/attn_core.cuh``)."""
    return 128 if s >= 256 else 64


def spatial_attention_composed(q, k, v, heads: int, scale: Optional[float] = None):
    """The reference's ``_spatial_xla``: the routed attention over (B, S,
    heads, D), the composition K4's gradient differentiates."""
    b, s, hd = q.shape
    d = hd // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    return dot_product_attention(
        q.reshape(b, s, heads, d), k.reshape(b, s, heads, d),
        v.reshape(b, s, heads, d), scale).reshape(b, s, hd)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, F, heads·D) → (B, F, heads·D), 1 ≤ F ≤ 24 on the card."""
    kernel = temporal_attention_reference if q.device.type == "cpu" else _temporal_kernel
    return with_composed_grad(lambda q, k, v: kernel(q, k, v, heads, scale),
                              lambda q, k, v: temporal_attention_reference(q, k, v, heads, scale),
                              q, k, v)


def _temporal_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                     scale: Optional[float]) -> torch.Tensor:
    b, f, hd = q.shape
    d = hd // heads
    if not 1 <= f <= TEMPORAL_MAX_FRAMES or d % 8 or hd != heads * d:
        raise ValueError(f"temporal_attention: needs 1 <= F <= {TEMPORAL_MAX_FRAMES} and "
                         f"D % 8 == 0, got F={f}, D={d}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _build.check_cuda("temporal_attention", q, k, v, o)
    _build.call("ls_temporal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _rows(q, "q"), _rows(k, "k"), _rows(v, "v"), o.data_ptr(), _rows(o, "o"),
                b, f, heads, d, scale, _build.stream(q))
    temporal_attention.launches += 1
    return o


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int, scale: Optional[float] = None,
                      block_q: Optional[int] = None) -> torch.Tensor:
    """q, k, v: (B, S, heads·D) → (B, S, heads·D).

    `block_q` is the query rows one block owns, one of
    ``SPATIAL_BLOCK_QS`` (the reference's argument of the same name tiles
    its grid the same way); by default the kernel picks it from S
    (``spatial_block_q``). The plain version has no tiles and ignores it."""
    if q.device.type == "cpu":
        def kernel(q, k, v):
            return spatial_attention_reference(q, k, v, heads, scale)
    else:
        def kernel(q, k, v):
            return _spatial_kernel(q, k, v, heads, scale, block_q)
    return with_composed_grad(kernel,
                              lambda q, k, v: spatial_attention_composed(q, k, v, heads, scale),
                              q, k, v)


def _spatial_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: Optional[float], block_q: Optional[int]) -> torch.Tensor:
    b, s, hd = q.shape
    d = hd // heads
    if d not in SPATIAL_HEAD_DIMS or hd != heads * d or s < 1:
        raise ValueError(f"spatial_attention: no kernel for D={d}, S={s} (head dims "
                         f"{SPATIAL_HEAD_DIMS})")
    if block_q is not None and block_q not in SPATIAL_BLOCK_QS:
        raise ValueError(f"spatial_attention: block_q={block_q} is not one of "
                         f"{SPATIAL_BLOCK_QS}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if not scale > 0:
        raise ValueError(f"spatial_attention: the kernel needs scale > 0, got {scale}")
    o = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _build.check_cuda("spatial_attention", q, k, v, o)
    if b == 0:
        return o
    _build.call("ls_spatial_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _rows(q, "q"), _rows(k, "k"), _rows(v, "v"), o.data_ptr(), _rows(o, "o"),
                b, s, heads, d, scale, block_q or 0, _build.stream(q))
    spatial_attention.launches += 1
    return o


temporal_attention.launches = 0
spatial_attention.launches = 0
