"""The stage-2 UNet trainer, on one card or data-parallel across several.

Counterpart of ``latentsync_tpu/training/unet_trainer.py``
(ref:scripts/train_unet.py:60-517): ε-MSE, and with pixel-space
supervision the one-step x̂₀ decoded by the frozen VAE for LPIPS on the
lower half, TREPA and the frozen SyncNet's cosine-BCE, with the same
weights, in the same order.

- Master weights are the UNet's f32 parameters; the forward casts them to
  the compute type (bf16 on the card) inside the graph
  (``torch.func.functional_call``), so each gradient arrives in f32 as the
  JAX model's f32 params receive theirs through its bf16 modules.
- Every UNet parameter gets a gradient, frozen ones too: the reference
  clips by the global norm of *all* of them before its mask
  (``optax.clip_by_global_norm`` ahead of ``optax.masked``,
  ``unet_trainer.py:63-70``), and so does ``clip_grad_norm_all``.
- Only ``trainable_mask``'s parameters (``motion_modules.`` and
  ``attentions.`` in stage 2) are in the optimizer: AdamW with optax's
  defaults (weight decay 1e-4, not torch's 1e-2; eps 1e-8 outside the
  square root; betas 0.9, 0.999). Frozen parameters never move and hold no
  optimizer state (``optax.set_to_zero``).
- The VAE encodes ground truth, masked and reference pixels without
  grad (frozen, and its inputs are data) and decodes x̂₀ with grad; the
  VAE, SyncNet, LPIPS and TREPA weights are frozen.
- ``t`` and the noise come from an explicit ``torch.Generator`` seeded from
  the run's seed and the step (the JAX trainer folds the step into its
  PRNG key); ``loss_fn`` also takes them given, which is how the tests
  inject the JAX draws. Under data parallelism (``parallel/mesh.py``) the
  draws are the global batch's and each rank takes its own rows; the
  gradients and the step's losses are averaged across ranks before the
  clip.

Batches are the data source's numpy arrays in the JAX package's layout:
frames (B, F, H, W, 3) in [-1, 1], masks (B, F, h, w, 1), audio embeddings
(B, F, S, D) and the mel (B, 80, T, 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import LatentSyncConfig
from ..models.vae import scale_latents, unscale_latents
from ..ops.ddim import DDIMScheduler
from ..parallel.mesh import average_, average_metrics
from .losses import cosine_bce_loss, mixed_noise

# optax.adamw's defaults (torch.optim.AdamW's weight decay is 1e-2)
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def trainable_mask(names: Sequence[str], trainable_modules: Sequence[str]) -> Dict[str, bool]:
    """True for each upstream-layout parameter name that contains one of the
    trainable-module substrings (``motion_modules.``, ``attentions.``,
    ``attn2.``, as the stage YAMLs spell them); every name when there are
    none."""
    subs = tuple(trainable_modules)
    return {n: any(s in n for s in subs) if subs else True for n in names}


def clip_grad_norm_all(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` over every gradient given, in place:
    unchanged below `max_norm`, else scaled by max_norm / norm. Returns
    the norm."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


def _frames(px: np.ndarray, device) -> torch.Tensor:
    """(B, F, H, W, 3) numpy → (B·F, 3, H, W) f32 tensor."""
    t = torch.as_tensor(np.ascontiguousarray(px), device=device, dtype=torch.float32)
    b, f, h, w, c = t.shape
    return t.reshape(b * f, h, w, c).permute(0, 3, 1, 2)


class UNetTrainer:
    """One training step of the stage-2 UNet. `unet` holds the f32 master
    weights; `vae` (and the optional `syncnet`, `lpips`, `trepa`) are
    frozen, in the compute type."""

    def __init__(self, config: LatentSyncConfig, unet: nn.Module, vae: nn.Module,
                 syncnet: Optional[nn.Module] = None, lpips: Optional[nn.Module] = None,
                 trepa=None, dtype: torch.dtype = torch.bfloat16):
        self.config = config
        self.unet, self.vae = unet, vae
        self.syncnet, self.lpips, self.trepa = syncnet, lpips, trepa
        self.dtype = dtype
        self.scheduler = DDIMScheduler.create(config.scheduler)
        for m in (vae, syncnet, lpips, None if trepa is None else trepa.model):
            if m is not None:
                m.requires_grad_(False)
        self.params = dict(unet.named_parameters())
        for p in self.params.values():
            p.requires_grad_(True)
        self.mask = trainable_mask(list(self.params), config.run.trainable_modules)
        self.optimizer = torch.optim.AdamW(
            [p for n, p in self.params.items() if self.mask[n]], lr=config.run.lr,
            betas=ADAMW_BETAS, eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def latent_shape(self, batch) -> Tuple[int, ...]:
        """(B, C, F, h, w) of the latents of `batch`."""
        b, f, h, w, _ = batch["gt_pixels"].shape
        s = self.config.vae.scale_factor
        return b, self.config.vae.latent_channels, f, h // s, w // s

    def draw(self, batch, step: int, rank: int = 0,
             ranks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """This step's (t (B,), noise (B, C, F, h, w)), from a generator seeded
        with (run seed, step); the draws are made on the CPU, so they do not
        depend on the device. With `ranks` data-parallel ranks of B samples
        each, the draws are the global batch's and this is rank `rank`'s
        share."""
        run = self.config.run
        gen = torch.Generator().manual_seed(int(run.seed) * 1_000_003 + int(step))
        shape = self.latent_shape(batch)
        b = shape[0]
        shape = (b * ranks,) + shape[1:]
        t = torch.randint(0, self.config.scheduler.num_train_timesteps, (shape[0],),
                          generator=gen)
        if run.use_mixed_noise:
            noise = mixed_noise(shape, run.mixed_noise_alpha, generator=gen)
        else:
            noise = torch.randn(shape, generator=gen)
        rows = slice(rank * b, (rank + 1) * b)
        return t[rows].to(self.device), noise[rows].to(self.device)

    def _encode(self, px: np.ndarray, b: int, f: int) -> torch.Tensor:
        with torch.no_grad():
            z = scale_latents(self.vae.encode(_frames(px, self.device).to(self.dtype)),
                              self.config.vae)
        return z.reshape((b, f) + z.shape[1:]).transpose(1, 2).float()

    def loss_fn(self, batch, t: torch.Tensor, noise: torch.Tensor):
        """(total, {component: value}) of `batch` at timesteps `t` with `noise`
        (the port's latent layout), differentiable in the UNet's master
        weights."""
        cfg, run = self.config, self.config.run
        dev, dt = self.device, self.dtype
        b, f, h = batch["gt_pixels"].shape[:3]
        gt_latents = self._encode(batch["gt_pixels"], b, f)
        masked_latents = self._encode(batch["masked_pixels"], b, f)
        ref_latents = self._encode(batch["ref_pixels"], b, f)
        lat_hw = gt_latents.shape[3:]
        masks = _frames(batch["masks"], dev)
        if masks.shape[2:] != lat_hw:
            # datasets give full-resolution masks; the UNet's mask channel is at
            # latent resolution (jax.image.resize "nearest": half-pixel centres)
            masks = F.interpolate(masks, size=lat_hw, mode="nearest-exact")
        masks = masks.reshape((b, f, 1) + lat_hw).transpose(1, 2)
        noisy = self.scheduler.add_noise(gt_latents, noise, t)
        unet_in = torch.cat([noisy, masks, masked_latents, ref_latents], dim=1).to(dt)
        audio = torch.as_tensor(batch["audio_embeds"], device=dev).to(dt)
        weights = {n: p.to(dt) for n, p in self.params.items()}
        eps = torch.func.functional_call(self.unet, weights, (unet_in, t, audio)).float()

        losses = {"recon": torch.mean((eps - noise) ** 2)}
        total = run.recon_loss_weight * losses["recon"]
        if run.pixel_space_supervise:
            x0 = self.scheduler.pred_x0(eps, noisy, t)
            flat = unscale_latents(x0, cfg.vae).transpose(1, 2).reshape(b * f, -1, *lat_hw)
            pix = self.vae.decode(flat.to(dt)).float()
            x0_pix = pix.reshape((b, f) + pix.shape[1:])          # (B, F, 3, H, W)
            gt_pix = _frames(batch["gt_pixels"], dev).reshape(x0_pix.shape)
            if self.lpips is not None:
                # the lower half only (ref:train_unet.py:372-377)
                lower = (x0_pix[:, :, :, h // 2:].flatten(0, 1).to(dt),
                         gt_pix[:, :, :, h // 2:].flatten(0, 1).to(dt))
                losses["perceptual"] = torch.mean(self.lpips(*lower).float())
                total = total + run.perceptual_loss_weight * losses["perceptual"]
            if self.trepa is not None:
                losses["trepa"] = self.trepa(x0_pix, gt_pix)
                total = total + run.trepa_loss_weight * losses["trepa"]
            if self.syncnet is not None:
                # frames stacked into channels, lower half (frame f's RGB at 3f..3f+2)
                vis = x0_pix[:, :, :, h // 2:].flatten(1, 2)
                mel = torch.as_tensor(batch["mel"], device=dev).permute(0, 3, 1, 2)
                v_emb, a_emb = self.syncnet(vis.to(dt), mel.to(dt))
                losses["sync"] = torch.mean(
                    cosine_bce_loss(v_emb, a_emb, torch.ones(b, device=dev)))
                total = total + run.sync_loss_weight * losses["sync"]
        losses["total"] = total
        return total, losses

    def gradients(self, batch, t, noise):
        """(losses, {name: gradient} of every UNet parameter)."""
        for p in self.params.values():
            p.grad = None
        total, losses = self.loss_fn(batch, t, noise)
        total.backward()
        return losses, {n: p.grad for n, p in self.params.items()}

    def train_step(self, batch, t, noise) -> Dict[str, float]:
        """One step: gradients of every parameter (averaged across
        data-parallel ranks), the clip over all of them, AdamW on the
        trainable set. Returns the loss components and the gradient norm
        before the clip, as floats."""
        losses, grads = self.gradients(batch, t, noise)
        average_(list(grads.values()))
        norm = clip_grad_norm_all(list(grads.values()), self.config.run.max_grad_norm)
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None
        out = average_metrics({k: float(v.detach()) for k, v in losses.items()}, self.device)
        out["grad_norm"] = float(norm)
        return out
