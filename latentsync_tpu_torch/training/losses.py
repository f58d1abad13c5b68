"""Training losses: the stage-2 SyncNet cosine-BCE and mixed noise, and
the restoration trainers' image and adversarial losses.

Counterpart of ``latentsync_tpu/training/losses.py``:
``cosine_bce_loss`` and ``mixed_noise`` (ref:latentsync/utils/util.py:
287-295, ref:scripts/train_unet.py:319-332; the one-step x̂₀ is
``ops/ddim.DDIMScheduler.pred_x0``), and basicsr's losses
(ref:basicsr/losses/losses.py): ``masked_l1``, ``charbonnier``,
``total_variation``, ``gan_loss``, ``r1_penalty``,
``gradient_penalty_loss`` and ``g_path_regularize``. Images are in the
port's (B, C, H, W). Where the JAX function draws from a PRNG key
(``gradient_penalty_loss``'s interpolation weights,
``g_path_regularize``'s noise) the port takes a ``torch.Generator``, or
the draw itself, which is how the tests hand both the same numbers. A
discriminator is a callable on images (the JAX functions take
``disc_fn(params, x)``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


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


def masked_l1(pred, target, mask=None):
    d = torch.abs(pred - target)
    if mask is not None:
        return torch.sum(d * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(d)


def charbonnier(pred, target, eps: float = 1e-12):
    """Charbonnier loss."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps))


def total_variation(x):
    """TV loss on (B, C, H, W): mean absolute difference of vertical
    neighbours plus that of horizontal ones."""
    dh = torch.mean(torch.abs(x[:, :, 1:] - x[:, :, :-1]))
    dw = torch.mean(torch.abs(x[:, :, :, 1:] - x[:, :, :, :-1]))
    return dh + dw


def gan_loss(pred, target_is_real: bool, mode: str = "hinge"):
    """GAN losses (basicsr's GANLoss): vanilla BCE on logits, lsgan MSE,
    hinge, wgan."""
    if mode == "vanilla":
        labels = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
        return torch.mean(torch.clamp(pred, min=0) - pred * labels
                          + torch.log1p(torch.exp(-torch.abs(pred))))
    if mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean((pred - target) ** 2)
    if mode == "hinge":
        if target_is_real:
            return torch.mean(F.relu(1.0 - pred))
        return torch.mean(F.relu(1.0 + pred))
    if mode == "wgan":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise ValueError(f"unknown gan mode {mode}")


def _input_grad(disc_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """d(sum disc_fn(x))/dx, kept in the graph so a penalty on it trains."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)[0]


def r1_penalty(disc_fn: Callable, real: torch.Tensor):
    """R1 gradient penalty: the mean over the batch of |∇ₓ D(real)|²."""
    grads = _input_grad(disc_fn, real)
    return torch.mean(torch.sum(grads**2, dim=tuple(range(1, grads.dim()))))


def gradient_penalty_loss(disc_fn: Callable, real: torch.Tensor, fake: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          alpha: Optional[torch.Tensor] = None):
    """WGAN-GP: unit-norm target on ∇D at interpolates alpha·real +
    (1 - alpha)·fake, alpha uniform a sample (drawn from `generator`
    unless given, shape (B, 1, ..., 1))."""
    if alpha is None:
        shape = (real.shape[0],) + (1,) * (real.dim() - 1)
        alpha = torch.rand(shape, generator=generator).to(real.device)
    grads = _input_grad(disc_fn, alpha * real + (1.0 - alpha) * fake)
    norms = torch.sqrt(torch.sum(grads**2, dim=tuple(range(1, grads.dim()))) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def g_path_regularize(fake_img: torch.Tensor, latents_grad_fn: Callable, mean_path_length,
                      decay: float = 0.01, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None):
    """StyleGAN2 path-length regularization: the noise-weighted generator
    Jacobian norm pulled toward its running mean. ``latents_grad_fn(noise)``
    returns d(sum(fake · noise))/d(latents) (the caller builds it with
    autograd over its generator). `noise` is N(0, 1) / sqrt(H W) of
    fake_img's shape, drawn from `generator` unless given. Returns
    (penalty, path lengths, new running mean)."""
    if noise is None:
        noise = torch.randn(fake_img.shape, generator=generator).to(fake_img.device)
        noise = noise / math.sqrt(fake_img.shape[-2] * fake_img.shape[-1])
    grad = latents_grad_fn(noise)
    path_lengths = torch.sqrt(torch.mean(torch.sum(grad**2, dim=tuple(range(1, grad.dim())))))
    path_mean = mean_path_length + decay * (path_lengths - mean_path_length)
    penalty = (path_lengths - path_mean) ** 2
    return penalty, path_lengths, path_mean
