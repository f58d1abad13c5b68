"""RRDBNet (the RealESRGAN upsampler's net) and the ArcFace identity net.

Counterpart of ``latentsync_tpu/models/rrdbnet.py`` (basicsr's
``rrdbnet_arch.py`` and ``arcface_arch.py``), forward only. State dicts keep
basicsr's layout (``conv_first``, ``body.N.rdbM.convK``, ``conv_up1`` ...;
``layerN.B.{bn0,conv1,bn1,prelu,conv2,bn2,downsample.0/.1}``, ``fc5``,
``bn5``); ``utils/convert.py`` ``rrdbnet_state_dict_from_flax`` and
``arcface_state_dict_from_flax`` carry the JAX package's variables across.
Plain torch (cuDNN on the card): the module computes in its weights' dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", nn.Conv2d(num_feat + i * num_grow_ch, num_grow_ch, 3,
                                                    1, 1))
        self.conv5 = nn.Conv2d(num_feat + 4 * num_grow_ch, num_feat, 3, 1, 1)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(feats, 1))))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """x2 / x4 super-resolution: (B, 3, H, W) in [0, 1] → (B, 3, sH, sW). The
    net always upsamples 4x; at scale 2 (1) the input is pixel-unshuffled by
    2 (4) first, as basicsr does for ``RealESRGAN_x2plus``."""

    def __init__(self, num_feat: int = 64, num_block: int = 23, num_grow_ch: int = 32,
                 scale: int = 2):
        super().__init__()
        self.scale = scale
        cin = 3 * {2: 4, 1: 16}.get(scale, 1)
        self.conv_first = nn.Conv2d(cin, num_feat, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch) for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)

    def forward(self, x):
        if self.scale in (1, 2):
            x = F.pixel_unshuffle(x, 4 if self.scale == 1 else 2)
        feat = self.conv_first(x.to(self.conv_first.weight.dtype))
        feat = feat + self.conv_body(self.body(feat))
        for conv in (self.conv_up1, self.conv_up2):
            feat = _lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
        return self.conv_last(_lrelu(self.conv_hr(feat)))


class SEBlock(nn.Module):
    """Squeeze-excite: pool → fc → PReLU → fc → sigmoid channel gates."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction), nn.PReLU(),
                                nn.Linear(channel // reduction, channel), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class IRBlock(nn.Module):
    """bn0 → conv1 → bn1 → PReLU → conv2 (stride) → bn2 → [SE] → + shortcut →
    the same PReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, use_se: bool = False):
        super().__init__()
        self.bn0 = nn.BatchNorm2d(inplanes)
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inplanes)
        self.prelu = nn.PReLU()
        self.conv2 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = SEBlock(planes) if use_se else None
        self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                        nn.BatchNorm2d(planes)) \
            if stride != 1 or inplanes != planes else None

    def forward(self, x):
        h = self.bn2(self.conv2(self.prelu(self.bn1(self.conv1(self.bn0(x))))))
        if self.se is not None:
            h = self.se(h)
        return self.prelu(h + (x if self.downsample is None else self.downsample(x)))


class ArcFaceResNet18(nn.Module):
    """ResNetArcFace: (B, 1, S, S) grey faces (S = 128 released) → (B, 512)."""

    def __init__(self, layers: Tuple[int, ...] = (2, 2, 2, 2), use_se: bool = False,
                 input_size: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 64, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.prelu = nn.PReLU()
        cin = 64
        for i, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if i == 0 else 2
            blocks = [IRBlock(cin, planes, stride, use_se)]
            blocks += [IRBlock(planes, planes, 1, use_se) for _ in range(layers[i] - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin = planes
        self.bn4 = nn.BatchNorm2d(512)
        hw = input_size // 16
        self.fc5 = nn.Linear(512 * hw * hw, 512)
        self.bn5 = nn.BatchNorm1d(512)

    def forward(self, x):
        h = F.max_pool2d(self.prelu(self.bn1(self.conv1(x))), 2, 2)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.bn5(self.fc5(self.bn4(h).flatten(1)))
