"""Trainer checkpoints: the UNet's f32 master weights, the optimizer state
and the step, in one ``torch.save`` file a step.

Counterpart of ``latentsync_tpu/utils/checkpoint.py`` (Orbax directories
``step_%08d`` there; no Orbax on the card): the files are named the same
way, ``step_%08d.pt``, and hold what the JAX package's do — parameters,
optimizer state, the step and an optional ``aux`` dict (the SyncNet
trainer's train / val loss histories, ``aux.npz`` there) — which the
reference's own trainer never saves (SURVEY §5.4).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def save_checkpoint(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict[str, Any]] = None,
                    aux: Optional[Dict[str, Any]] = None) -> str:
    """Write ``step_<step>.pt`` (atomically: a temporary file, then a rename).
    `aux` values are array-likes (lists of ``(step, loss)`` pairs); they are
    stored as nested lists, beside ``step`` as the JAX ``aux.npz`` holds it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pt"))
    payload = {"step": step, "params": {k: v.detach().cpu() for k, v in params.items()}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if aux is not None:
        payload["aux"] = {"step": step, **{k: np.asarray(v).tolist() for k, v in aux.items()}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".pt"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """{"step", "params", and "opt_state" and "aux" where saved}, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
