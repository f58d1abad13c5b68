"""The SyncNet trainer.

Counterpart of ``latentsync_tpu/training/syncnet_trainer.py``
(ref:scripts/train_syncnet.py:39-262): cosine-BCE supervision of the
twin-tower StableSyncNet (``models/syncnet.py``).

- Master weights are the net's f32 parameters; the forward casts them to
  the compute type (bf16 on the card) inside the graph
  (``torch.func.functional_call``), as ``training/unet_trainer.py`` does,
  so each gradient arrives in f32 as the JAX model's f32 params receive
  theirs through its bf16 modules.
- The optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
  adamw(lr))``: the clip over every gradient (``clip_grad_norm_all``),
  then AdamW with optax's defaults (weight decay 1e-4, not torch's 1e-2).
- A train step returns the loss and ``sat_frac``, the share of samples whose
  similarity sits on the BCE clip's boundary (they give no gradient; a
  collapsed net shows 1.0); an eval step the loss and the threshold
  accuracy at cos-sim ≥ 0.5 (ref:eval/eval_syncnet_acc.py).
- Under data parallelism (``parallel/mesh.py``) the gradients and the
  step's metrics are averaged across ranks before the clip.

Batches are the data source's numpy arrays in the JAX package's layout:
vision (B, H/2, W, F·3), mel (B, 80, T, 1), y (B,).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import LatentSyncConfig
from ..models.syncnet import StableSyncNet
from ..parallel.mesh import average_, average_metrics
from ..utils.convert import fast_init_
from .losses import cosine_bce_loss
from .unet_trainer import ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY, clip_grad_norm_all

# a similarity within this of 0 or 1 sits on the BCE clip (cosine_bce_loss's eps)
SAT_EPS = 1e-7


class SyncNetTrainer:
    """`model` holds the f32 master weights (default: a StableSyncNet of
    ``config.syncnet`` filled as the JAX trainer's ``fast_init`` fills it,
    seed 0), on `device`."""

    def __init__(self, config: LatentSyncConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", model: Optional[StableSyncNet] = None):
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
        if model is None:
            with torch.device(self.device):
                model = fast_init_(StableSyncNet(config.syncnet), seed=0)
        self.model = model.to(self.device, torch.float32).train()
        self.params = dict(self.model.named_parameters())
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=config.run.lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
            weight_decay=ADAMW_WEIGHT_DECAY)

    def embed(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vision, audio) unit embeddings of `batch`, f32 master weights cast
        to the compute type in the graph."""
        dev, dt = self.device, self.dtype
        vision = torch.as_tensor(np.asarray(batch["vision"]), device=dev).permute(0, 3, 1, 2)
        mel = torch.as_tensor(np.asarray(batch["mel"]), device=dev).permute(0, 3, 1, 2)
        weights = {n: p.to(dt) for n, p in self.params.items()}
        return torch.func.functional_call(self.model, weights, (vision.to(dt), mel.to(dt)))

    def _labels(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch["y"]), device=self.device, dtype=torch.float32)

    def loss_and_sat(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean cosine-BCE, the share of samples on the clip's boundary)."""
        v, a = self.embed(batch)
        sims = torch.sum(v.float() * a.float(), dim=-1)
        loss = torch.mean(cosine_bce_loss(v, a, self._labels(batch)))
        sat = torch.mean(((sims <= SAT_EPS) | (sims >= 1.0 - SAT_EPS)).float())
        return loss, sat

    def gradients(self, batch) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, sat_frac, {name: gradient}) of this rank's batch."""
        for p in self.params.values():
            p.grad = None
        loss, sat = self.loss_and_sat(batch)
        loss.backward()
        return loss, sat, {n: p.grad for n, p in self.params.items()}

    def train_step(self, batch) -> Dict[str, float]:
        """One step: gradients (averaged across data-parallel ranks), the clip
        over all of them, AdamW. Returns loss, sat_frac and the gradient norm
        before the clip, as floats."""
        loss, sat, grads = self.gradients(batch)
        average_(list(grads.values()))
        norm = clip_grad_norm_all(list(grads.values()), self.config.run.max_grad_norm)
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None
        metrics = average_metrics({"loss": float(loss.detach()), "sat_frac": float(sat)},
                                  self.device)
        return dict(metrics, grad_norm=float(norm))

    @torch.no_grad()
    def eval_step(self, batch) -> Tuple[float, float]:
        """(loss, accuracy): the mean cosine-BCE and the share of samples whose
        thresholded similarity (≥ 0.5) equals the label."""
        v, a = self.embed(batch)
        y = self._labels(batch)
        sims = torch.sum(v.float() * a.float(), dim=-1)
        loss = torch.mean(cosine_bce_loss(v, a, y))
        acc = torch.mean(((sims >= 0.5).float() == y).float())
        metrics = average_metrics({"loss": float(loss), "acc": float(acc)}, self.device)
        return metrics["loss"], metrics["acc"]
