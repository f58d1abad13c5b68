"""Multi-head scaled-dot-product attention in plain torch.

Counterpart of ``latentsync_tpu/ops/attention.py``
``dot_product_attention``: (..., S, H, D) layout, f32 logits and softmax
whatever the input dtype, probabilities rounded to the input dtype
before the value product. It serves the audio cross-attention, the
whisper encoder and the VAE mid-block (S = 1024, one head, D = 512),
where the JAX package used XLA or jax's library flash kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (..., Sq, H, D); k, v: (..., Sk, H, D) → (..., Sq, H, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qh = q.transpose(-3, -2).float()                   # (..., H, Sq, D)
    kh = k.transpose(-3, -2).float()
    logits = (qh @ kh.transpose(-1, -2)) * scale       # (..., H, Sq, Sk)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = w @ v.transpose(-3, -2)                        # (..., H, Sq, D)
    return o.transpose(-3, -2)
