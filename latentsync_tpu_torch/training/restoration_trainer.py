"""Face-restoration trainers: the VQGAN stage and CodeFormer's stages II and
III, on one card.

Counterpart of ``latentsync_tpu/training/restoration_trainer.py`` (the
basicsr model wrappers, ref:basicsr/models/vqgan_model.py,
codeformer_idx_model.py, codeformer_joint_model.py): (I) VQGAN
reconstruction + codebook + GAN, (II) code-index prediction by
cross-entropy against the VQGAN codes of the ground truth, (III) joint
tuning with the fuse blocks, L1 + GAN. Each step is the JAX step's, in its
order, with its quirks kept:

- Master weights are f32 (``Net``); the forward casts them to the compute
  type (bf16 on the card) inside the graph (``torch.func.functional_call``),
  norms' parameters and statistics left in f32, as the JAX modules compute
  with their f32 params at ``dtype=bf16``. Gradients arrive in f32.
- The discriminator's batch-norm running mean and variance are in its
  variables in the JAX package (``batch_stats``), and its step
  differentiates all of them: so they are leaves here too, with
  gradients and optimizer state (the running statistics are never updated
  from batches, as flax's ``use_running_average=True`` does not).
- The discriminator step of stages I and III recomputes the generator's
  output with the generator as the generator step has just left it
  (under ``torch.no_grad()``), as the JAX step does; it does not reuse the
  first output.
- Stage II's target codes come from the *current* generator's encoder and
  quantizer on the ground truth, without gradient, not from a frozen
  VQGAN copy; its cross-entropy is taken over f32 logits.
- A leaf the loss does not reach gets a zero gradient, as ``jax.grad``
  gives it (so Adam leaves it where it is and AdamW still decays it).

Batches are dicts of "lq" / "gt" images in the JAX package's layout,
(B, H, W, 3) in [-1, 1], numpy arrays or tensors; the trainers move them to
the card and into (B, 3, H, W).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.codeformer import CodeFormer, VQAutoEncoder, VQGANDiscriminator, _dtype
from .losses import gan_loss

_NORMS = (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)


class _Apply(nn.Module):
    """``fn(module, *args)`` under ``functional_call``: flax's ``apply(...,
    method=fn)``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, fn, *args, **kwargs):
        return fn(self.m, *args, **kwargs)


def _call(m, *args, **kwargs):
    return m(*args, **kwargs)


class Net:
    """A module with f32 master leaves — its parameters and its batch norms'
    running mean and variance — applied with them cast to `dtype` inside the
    graph (the norms' stay f32). ``net(x, ...)`` runs the forward; ``method``
    runs ``method(module, x, ...)`` instead; ``detach`` applies it with
    leaves that take no gradient."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        self.module = module.float()
        self.dtype = dtype
        self._apply = _Apply(self.module)
        keep = set()
        for prefix, m in self.module.named_modules():
            if isinstance(m, _NORMS):
                keep.update(f"{prefix}.{n}" if prefix else n
                            for n, _ in list(m.named_parameters(recurse=False))
                            + list(m.named_buffers(recurse=False)))
        self.leaves: Dict[str, torch.Tensor] = dict(self.module.named_parameters())
        for name, buf in self.module.named_buffers():
            if buf.is_floating_point():
                self.leaves[name] = buf
        for t in self.leaves.values():
            t.requires_grad_(True)
        self._f32 = keep

    def weights(self, detach: bool = False) -> Dict[str, torch.Tensor]:
        out = {}
        for name, t in self.leaves.items():
            if detach:
                t = t.detach()
            out["m." + name] = t if name in self._f32 else t.to(self.dtype)
        return out

    def __call__(self, *args, method: Callable = _call, detach: bool = False, **kwargs):
        return torch.func.functional_call(self._apply, self.weights(detach),
                                          (method,) + args, kwargs)

    def zero_missing_grads(self) -> None:
        for t in self.leaves.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.leaves.items()}


def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """ema · decay + params · (1 - decay), in place (the JAX function
    returns a new tree; the same two roundings a leaf)."""
    with torch.no_grad():
        for k, e in ema.items():
            e.mul_(decay).add_(params[k].detach() * (1 - decay))
    return ema


def _images(batch, key: str, device) -> torch.Tensor:
    """(B, H, W, 3) images of the batch → (B, 3, H, W) f32 on `device`."""
    x = batch[key]
    x = torch.as_tensor(np.ascontiguousarray(x)) if not torch.is_tensor(x) else x
    return x.to(device, torch.float32).permute(0, 3, 1, 2)


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach()) for k, v in metrics.items()}


def _update(net: Net, opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    net.zero_missing_grads()
    opt.step()


class VQGANTrainer:
    """Stage I: VQ autoencoder + patch discriminator."""

    def __init__(self, model: VQAutoEncoder, disc: VQGANDiscriminator, l1_weight: float = 1.0,
                 codebook_weight: float = 1.0, gan_weight: float = 0.8,
                 dtype: torch.dtype = torch.bfloat16):
        self.g, self.d = Net(model, dtype), Net(disc, dtype)
        self.l1_weight, self.codebook_weight, self.gan_weight = \
            l1_weight, codebook_weight, gan_weight

    @property
    def device(self):
        return next(iter(self.g.leaves.values())).device

    def g_loss(self, batch):
        gt = _images(batch, "gt", self.device)
        rec, cb_loss, _ = self.g(gt)
        l1 = torch.mean(torch.abs(rec.float() - gt))
        adv = gan_loss(self.d(rec, detach=True).float(), True, "hinge")
        total = self.l1_weight * l1 + self.codebook_weight * cb_loss.float() \
            + self.gan_weight * adv
        return total, {"l1": l1, "codebook": cb_loss, "adv": adv}

    def d_loss(self, batch):
        gt = _images(batch, "gt", self.device)
        with torch.no_grad():
            rec = self.g(gt)[0]
        real = gan_loss(self.d(gt).float(), True, "hinge")
        fake = gan_loss(self.d(rec).float(), False, "hinge")
        return 0.5 * (real + fake), {"d_real": real, "d_fake": fake}

    def make_steps(self, g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer):
        """The step: the generator's update, then the discriminator's against
        the updated generator; returns the metrics as floats."""

        def train_step(batch) -> Dict[str, float]:
            gl, gm = self.g_loss(batch)
            _update(self.g, g_opt, gl)
            dl, dm = self.d_loss(batch)
            _update(self.d, d_opt, dl)
            return {**_floats(gm), **_floats(dm), "g": float(gl.detach()),
                    "d": float(dl.detach())}

        return train_step


class CodeFormerStageII:
    """Stage II: transformer code prediction — cross-entropy between the
    code logits of the LQ input and the codes of the GT."""

    def __init__(self, model: CodeFormer, dtype: torch.dtype = torch.bfloat16):
        self.g = Net(model, dtype)

    @property
    def device(self):
        return next(iter(self.g.leaves.values())).device

    def target_codes(self, gt: torch.Tensor) -> torch.Tensor:
        """(B, T) codes of the GT by the current encoder and quantizer."""

        def codes(m, x):
            return m.quantize(m.encoder(x.to(_dtype(m))))[2]

        with torch.no_grad():
            idx = self.g(gt, method=codes)
        return idx.reshape(idx.shape[0], -1)

    def loss(self, batch):
        lq = _images(batch, "lq", self.device)
        logits, _ = self.g(lq, code_only=True)
        idx = self.target_codes(_images(batch, "gt", self.device))
        logp = F.log_softmax(logits.float(), dim=-1)
        ce = -torch.mean(torch.gather(logp, -1, idx[..., None]))
        acc = torch.mean((logits.argmax(-1) == idx).float())
        return ce, {"ce": ce, "code_acc": acc}

    def make_step(self, opt: torch.optim.Optimizer):
        def train_step(batch) -> Dict[str, float]:
            loss, metrics = self.loss(batch)
            _update(self.g, opt, loss)
            return _floats(metrics)

        return train_step


class CodeFormerStageIII:
    """Stage III: joint tuning with the fuse blocks — L1 + GAN."""

    def __init__(self, model: CodeFormer, disc: VQGANDiscriminator, l1_weight: float = 1.0,
                 gan_weight: float = 1.0, fidelity_weight: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        self.g, self.d = Net(model, dtype), Net(disc, dtype)
        self.l1_weight, self.gan_weight, self.fidelity_weight = \
            l1_weight, gan_weight, fidelity_weight

    @property
    def device(self):
        return next(iter(self.g.leaves.values())).device

    def g_loss(self, batch):
        lq = _images(batch, "lq", self.device)
        out, _, _ = self.g(lq, self.fidelity_weight)
        l1 = torch.mean(torch.abs(out.float() - _images(batch, "gt", self.device)))
        adv = gan_loss(self.d(out, detach=True).float(), True, "hinge")
        return self.l1_weight * l1 + self.gan_weight * adv, {"l1": l1, "adv": adv}

    def d_loss(self, batch):
        with torch.no_grad():
            out = self.g(_images(batch, "lq", self.device), self.fidelity_weight)[0]
        real = gan_loss(self.d(_images(batch, "gt", self.device)).float(), True, "hinge")
        fake = gan_loss(self.d(out).float(), False, "hinge")
        return 0.5 * (real + fake), {}

    def make_step(self, g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer):
        def train_step(batch) -> Dict[str, float]:
            gl, gm = self.g_loss(batch)
            _update(self.g, g_opt, gl)
            dl, _ = self.d_loss(batch)
            _update(self.d, d_opt, dl)
            return {**_floats(gm), "g": float(gl.detach()), "d": float(dl.detach())}

        return train_step
