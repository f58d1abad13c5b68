"""Multi-head scaled-dot-product attention, routed like the reference.

Counterpart of ``latentsync_tpu/ops/attention.py``
``dot_product_attention``: (..., S, H, D) layout, f32 logits and softmax
whatever the input dtype, probabilities rounded to the input dtype
before the value product.

``dot_product_attention`` routes exactly as the reference does
(``attention.py:51-57``): unmasked 4-D self-attention with S ≥ 256 and
S a multiple of 128 — on the serving path the VAE mid-block (S = 1024,
one head, D = 512), where the TPU ran jax's library flash kernel —
launches the hand-written flash kernel of ``csrc/flash_attention.cu``
on a CUDA tensor. Everything else (whisper's S = 1500, the audio
cross-attention with Sk = 50) and every CPU tensor runs the plain
``dot_product_attention_reference``, which is also what the plain
versions of the other attention ops call.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

FLASH_HEAD_DIM = 512  # the VAE mid-block's; the kernel takes no other


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain version. q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(-3, -2).float()                   # (..., H, Sq, D)
    kh = k.transpose(-3, -2).float()
    logits = (qh @ kh.transpose(-1, -2)) * scale       # (..., H, Sq, Sk)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = w @ v.transpose(-3, -2)                        # (..., H, Sq, D)
    return o.transpose(-3, -2)


def flash_route(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the reference sent this (unmasked) call to its flash kernel:
    4-D self-attention, S ≥ 256, S a multiple of 128 (``_pick_block``)."""
    s = q.shape[1] if q.dim() == 4 else 0
    return q.dim() == 4 and s >= 256 and s == k.shape[1] and s % 128 == 0


def _strides(t: torch.Tensor, name: str):
    """(batch, seq, head) strides of a (B, S, H, D) view with a contiguous
    last axis and 16-byte aligned rows."""
    sb, ss, sh, sd = t.stride()
    if sd != 1 or sb % 8 or ss % 8 or sh % 8:
        raise ValueError(f"dot_product_attention: unsupported {name} strides {t.stride()}")
    return sb, ss, sh


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D)."""
    if q.device.type == "cpu" or not flash_route(q, k):
        return dot_product_attention_reference(q, k, v, scale)
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or d != FLASH_HEAD_DIM:
        raise ValueError(f"dot_product_attention: no flash kernel for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty((b, s, h, d), device=q.device, dtype=q.dtype)
    _build.check_cuda("dot_product_attention", q, k, v, o)
    _build.call("ls_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"), o.data_ptr(),
                b, s, h, d, scale, _build.stream(q))
    dot_product_attention.launches += 1
    return o


dot_product_attention.launches = 0
