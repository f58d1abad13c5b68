"""Stage-2 training losses: the SyncNet cosine-BCE and mixed noise.

Counterpart of ``latentsync_tpu/training/losses.py`` ``cosine_bce_loss``
and ``mixed_noise`` (ref:latentsync/utils/util.py:287-295,
ref:scripts/train_unet.py:319-332). The one-step x̂₀ is
``ops/ddim.DDIMScheduler.pred_x0``.
"""

from __future__ import annotations

import math

import torch


def cosine_bce_loss(vision_embeds: torch.Tensor, audio_embeds: torch.Tensor,
                    labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """BCE(cos_sim(v, a), y) per sample. The embeddings are unit vectors, so
    the similarity is their dot product, taken in f32 whatever their type
    (bf16 would round a near-collapsed similarity to exactly 1, where the
    clip's zero gradient stops training), then clipped to [eps, 1 - eps]."""
    sims = torch.sum(vision_embeds.float() * audio_embeds.float(), dim=-1)
    p = torch.clamp(sims, eps, 1.0 - eps)
    y = labels.float()
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def mixed_noise(shape, alpha: float = 1.0, generator=None, device=None) -> torch.Tensor:
    """Per-frame noise plus noise shared across frames, variance-normalised:
    (eps_i + alpha · eps_shared) / sqrt(1 + alpha²). `shape` is the port's
    latent layout (B, C, F, h, w): the shared draw has F = 1."""
    per_frame = torch.randn(shape, generator=generator, device=device)
    shared = torch.randn(shape[:2] + (1,) + tuple(shape[3:]), generator=generator,
                         device=device)
    return (per_frame + alpha * shared) / math.sqrt(1.0 + alpha**2)
