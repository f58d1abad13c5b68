"""Inception-3D (I3D, Kinetics-400), the feature network of FVD.

Counterpart of ``latentsync_tpu/models/i3d.py``: the reference scores FVD
with a TorchScript I3D (ref:eval/fvd.py:28-44, ``return_features=True``,
pre-softmax logits), the public Inception-v1-3D whose PyTorch ports
(piergiaj's ``pytorch-i3d``) expose a plain state dict. The port keeps that
naming (``Conv3d_1a_7x7.conv3d.weight``, ``Mixed_4b.b1b.bn.running_var``,
``logits.conv3d.bias``), so such a file loads as it is.

Convolutions and max pools pad as TensorFlow's (and flax's) ``SAME``: the
total ``max(k - s, 0)`` or ``max(k - in % s, 0)`` split with the odd one
after, as piergiaj's ``compute_pad`` does; torch's symmetric padding gives
the same output size shifted by one wherever the total is odd (at
``Conv3d_1a_7x7`` on 16×224²: 2 before, 3 after). Max pools pad with −inf.
Batch norms in inference mode at eps 1e-3. Input (B, 3, T, H, W) in
[-1, 1].
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_pads(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int]):
    """``F.pad`` amounts (last dim first) of TF ``SAME`` padding for a map of
    spatial `size` (T, H, W)."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max(k - s, 0) if n % s == 0 else max(k - n % s, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    pads = same_pads(x.shape[2:], kernel, stride)
    return F.max_pool3d(F.pad(x, pads, value=-math.inf), kernel, stride)


class Unit3D(nn.Module):
    """conv3d with ``SAME`` padding + (optional) batch norm + (optional) ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = kernel, stride, activation
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(k > 1 for k in self.kernel):
            x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride))
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    """Four-branch inception block (piergiaj naming b0 / b1a / b1b / b2a /
    b2b / b3b)."""

    def __init__(self, cin: int, ch: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(cin, ch[0])
        self.b1a = Unit3D(cin, ch[1])
        self.b1b = Unit3D(ch[1], ch[2], (3, 3, 3))
        self.b2a = Unit3D(cin, ch[3])
        self.b2b = Unit3D(ch[3], ch[4], (3, 3, 3))
        self.b3b = Unit3D(cin, ch[5])
        self.out_channels = ch[0] + ch[2] + ch[4] + ch[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], 1)


# the public Inception-v1 / Kinetics-400 channel plan, in network order
MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


class InceptionI3D(nn.Module):
    """(B, 3, T, H, W) video in [-1, 1] → (B, 400) Kinetics-400 pre-softmax logits
    (the reference's ``return_features=True``), or with ``features="pool"``
    the (B, 1024) Mixed_5c features pooled over space and time (no head)."""

    def __init__(self, features: str = "logits"):
        super().__init__()
        self.features = features
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, ch in MIXED.items():
            block = InceptionModule(cin, ch)
            self.add_module(name, block)
            cin = block.out_channels
        # the JAX module makes its head only where it is used
        self.logits = Unit3D(cin, 400, use_bn=False, activation=False,
                             use_bias=True) if features == "logits" else None

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(video)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # the mean over space, then (per time step) the logits, then over time:
        # the JAX module's order (exact at the FVD point, 16 × 224²)
        pooled = x.mean(dim=(3, 4))  # (B, C, T')
        if self.features == "pool":
            return pooled.mean(-1)
        return self.logits(pooled[..., None, None])[..., 0, 0].mean(-1)
