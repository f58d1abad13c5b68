"""Train the packaged no-checkpoint landmark fallback on the card (the port's
counterpart of ``scripts/train_landmark_fallback.py``).

    python -m latentsync_tpu_torch.scripts.train_landmark_fallback --steps 2000 \\
        --out latentsync_tpu_torch/utils/assets/landmark_fallback.npz [--device cpu]

A small 2D-FAN (``models/face_detection.py`` ``FAN2D``: 1 hourglass module
× 128 features by default) learns 68 landmarks on procedurally rendered
faces whose landmarks are known by construction
(``training/synthetic_faces.py``). The dataset is drawn once on the host
from ``--seed`` and goes to the card once, as uint8; each step then samples
its batch (a ``torch.Generator`` on the card), scales it to [0, 1] and
renders its gaussian heatmap targets there (:func:`device_heatmaps`), so
the host link carries nothing a step. The loss is the JAX script's
positive-weighted MSE summed over every module's output; the optimizer
its ``optax.chain(clip_by_global_norm(1.0), adam(warmup_cosine_decay_
schedule(...)))``; the batch norms train as flax's ``nn.BatchNorm`` does
(:class:`FlaxBatchNorm2d`). Every ``--eval-every`` steps it prints the
NME of the 64 held-out faces (:func:`device_decode`, :func:`nme`) as a
JSON line. It saves the f16 state dict (without ``num_batches_tracked``)
in the layout of the port's ``utils/assets/landmark_fallback.npz``, which
``utils/image_processor.py``'s fallback loader reads. The card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

HEAT = 64  # heatmap side (stride-4 grid of the 256px crop)
N_EVAL = 64  # held-out faces, the first of the dataset


def device_heatmaps(pts: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """(B, 68, 2) pixel landmarks → (B, 68, 64, 64) gaussian targets on
    their device (``synthetic_faces.landmark_heatmaps``, channels first)."""
    grid = torch.arange(HEAT, dtype=torch.float32, device=pts.device)
    p = pts.float() / 4.0 - 0.5
    d2 = (grid[None, None, None, :] - p[..., 0, None, None]) ** 2 \
        + (grid[None, None, :, None] - p[..., 1, None, None]) ** 2
    return torch.exp(-d2 / (2 * sigma**2))


def device_decode(heat: torch.Tensor) -> torch.Tensor:
    """(B, 68, 64, 64) → (B, 68, 2) argmax landmark coords in 256-px crop
    space (the integer decode of the evaluation NME; the first maximum)."""
    b, n, h, w = heat.shape
    idx = heat.reshape(b, n, h * w).argmax(-1)
    return (torch.stack([idx % w, idx // w], -1).float() + 0.5) * 4.0


def nme(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean landmark error over the outer-eye-corner distance (iBUG NME)."""
    inter = torch.linalg.norm(gt[:, 45] - gt[:, 36], dim=-1)
    err = torch.linalg.norm(pred - gt, dim=-1).mean(-1)
    return (err / inter.clamp_min(1e-3)).mean()


def warmup_cosine_decay(count: int, peak: float, warmup: int, decay_steps: int,
                        end: float) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay_steps,
    end)`` at `count`: linear from 0 over `warmup` steps, then a cosine to
    `end` over the remaining ``decay_steps - warmup``."""
    if count < warmup:
        return peak * count / warmup
    span = decay_steps - warmup
    cosine = 0.5 * (1 + math.cos(math.pi * min(count - warmup, span) / span))
    alpha = end / peak
    return peak * ((1 - alpha) * cosine + alpha)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that trains as flax's ``nn.BatchNorm`` (the JAX
    FAN's, ``models/face_detection.py:273,284``): the batch's statistics
    as E[x²] − E[x]² (flax's fast variance, clipped at 0) normalise the
    batch, and the running statistics move by momentum 0.99 towards the
    batch mean and its *biased* variance. torch's own training mode moves
    them by 0.1 (0.9 kept) towards the unbiased variance. Evaluation uses
    the running statistics either way."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(0.01 * mean)
            self.running_var.mul_(0.99).add_(0.01 * var)
        y = (xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def flax_batch_norm_(model: nn.Module) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of `model` trains as flax's."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = FlaxBatchNorm2d
    return model


class LandmarkTrainer:
    """The JAX script's train step and evaluation on one device: `images`
    (N, 256, 256, 3) uint8 and `landmarks` (N, 68, 2) go there once; faces
    ``[:64]`` are held out."""

    def __init__(self, images: np.ndarray, landmarks: np.ndarray, steps: int,
                 modules: int = 1, features: int = 128, lr: float = 1e-3,
                 pos_weight: float = 30.0, sigma: float = 1.5, batch: int = 16, seed: int = 0,
                 device="cuda", model: nn.Module | None = None):
        from ..models.face_detection import FAN2D

        self.device = torch.device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self.landmarks = torch.from_numpy(np.ascontiguousarray(landmarks, np.float32)).to(
            self.device)
        self.n = len(images)
        self.batch, self.pos_weight, self.sigma = batch, pos_weight, sigma
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = FAN2D(num_modules=modules, features=features)
        self.model = flax_batch_norm_(model).to(self.device)
        self.params = [p for p in self.model.parameters()]
        self.opt = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        self.schedule = dict(peak=lr, warmup=min(100, steps // 2),
                             decay_steps=max(steps, steps // 2 + 1), end=lr * 0.01)
        self.count = 0
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def sample(self) -> torch.Tensor:
        return torch.randint(N_EVAL, self.n, (self.batch,), generator=self.gen,
                             device=self.device)

    def train_step(self, idx: torch.Tensor | None = None) -> torch.Tensor:
        """One step on faces `idx` (drawn from the trainer's generator by
        default); returns the loss (a device scalar)."""
        idx = self.sample() if idx is None else idx.to(self.device)
        x = self.images[idx].permute(0, 3, 1, 2).float() / 255.0
        target = device_heatmaps(self.landmarks[idx], sigma=self.sigma)
        self.model.train()
        outs = self.model(x)
        w = 1.0 + self.pos_weight * target
        loss = sum(torch.mean(w * (o - target) ** 2) for o in outs)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():  # optax.clip_by_global_norm(1.0)
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in self.params))
            scale = torch.where(norm < 1.0, torch.ones_like(norm), 1.0 / norm)
            for p in self.params:
                p.grad.mul_(scale)
        for group in self.opt.param_groups:
            group["lr"] = warmup_cosine_decay(self.count, **self.schedule)
        self.opt.step()
        self.count += 1
        return loss.detach()

    @torch.no_grad()
    def eval_nme(self) -> float:
        self.model.eval()
        x = self.images[:N_EVAL].permute(0, 3, 1, 2).float() / 255.0
        heat = self.model(x)[-1]
        return float(nme(device_decode(heat), self.landmarks[:N_EVAL]))

    def state_dict_f16(self) -> dict:
        """The asset: every float tensor in f16, ``num_batches_tracked``
        left out (the packaged asset's layout)."""
        return {k: v.detach().cpu().half().numpy() for k, v in self.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}


def render_dataset(n: int, seed: int, hair_p: float = 0.0):
    """`n` faces from ``np.random.default_rng(seed)``, as the JAX script
    draws them: (images (n, 256, 256, 3) uint8, landmarks (n, 68, 2))."""
    from ..training.synthetic_faces import render_face

    rng = np.random.default_rng(seed)
    images = np.empty((n, 256, 256, 3), np.uint8)
    landmarks = np.empty((n, 68, 2), np.float32)
    for i in range(n):
        images[i], landmarks[i] = render_face(rng, 256, hair_p=hair_p)
    return images, landmarks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--dataset", type=int, default=4000,
                   help="unique synthetic faces (64 held out for eval)")
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--modules", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--pos-weight", type=float, default=30.0,
                   help="extra MSE weight on heatmap-positive pixels")
    p.add_argument("--sigma", type=float, default=1.5,
                   help="gaussian target radius on the 64² grid")
    p.add_argument("--hair-p", type=float, default=0.0,
                   help="hair-rendering probability (the shipped asset uses 0)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=250)
    p.add_argument("--out", default=os.path.join("latentsync_tpu_torch", "utils", "assets",
                                                 "landmark_fallback.npz"))
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("train_landmark_fallback", args.device):
        return 2
    if args.dataset <= N_EVAL:
        p.error(f"--dataset must exceed the {N_EVAL} held-out faces")
    t0 = time.time()
    images, landmarks = render_dataset(args.dataset, args.seed, args.hair_p)
    print(json.dumps({"generated": args.dataset, "s": round(time.time() - t0, 3)}), flush=True)
    trainer = LandmarkTrainer(images, landmarks, args.steps, args.modules, args.features,
                              args.lr, args.pos_weight, args.sigma, args.batch, args.seed,
                              args.device)
    n_params = sum(p.numel() for p in trainer.params)
    print(json.dumps({"modules": args.modules, "features": args.features,
                      "params_m": round(n_params / 1e6, 3)}), flush=True)
    t0 = time.time()
    v = math.nan
    for step in range(1, args.steps + 1):
        loss = trainer.train_step()
        if step % args.eval_every == 0 or step == args.steps:
            v = trainer.eval_nme()
            print(json.dumps({"step": step, "loss": float(loss), "eval_nme": v,
                              "s": round(time.time() - t0, 3)}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **trainer.state_dict_f16())
    print(json.dumps({"saved": args.out, "mb": round(os.path.getsize(args.out) / 1e6, 3),
                      "final_eval_nme": v}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
