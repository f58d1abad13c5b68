"""Face parsing for the restore helper's paste-back masks: ParseNet and BiSeNet.

Counterpart of ``latentsync_tpu/models/parsing.py`` (facelib's
``parsing/parsenet.py``, ``bisenet.py`` and ``resnet.py``). State dicts keep
facelib's layout (ParseNet ``encoder.N`` / ``body.N`` / ``decoder.N`` with
``conv1`` / ``conv2`` / ``shortcut_func`` layers and the batch norm at
``<layer>.norm.norm``; BiSeNet ``cp.resnet.*``, ``cp.arm16`` ..., ``ffm.*``,
``conv_out{,16,32}.*``); ``utils/convert.py`` carries the JAX package's
variables across (``parsenet_state_dict_from_flax``,
``bisenet_state_dict_from_flax``). Nearest resizes sample at pixel centres
as ``jax.image.resize`` does; BiSeNet's heads are resized bilinearly with
aligned corners. Plain torch (cuDNN on the card), f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .face_detection import _load, no_tf32


def _nearest(x, size):
    return F.interpolate(x, size=size, mode="nearest-exact")


class _Norm(nn.Module):
    """facelib's NormLayer wrapper: the batch norm sits at ``norm.norm``."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(ch)

    def forward(self, x):
        return self.norm(x)


class ConvLayer(nn.Module):
    """Optional nearest x2 up / stride-2 down, reflection pad 1, 3x3 conv
    (no bias under a batch norm), optional BN, optional LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, scale: str = "none", norm: bool = False,
                 relu: bool = False):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.conv2d = nn.Conv2d(cin, cout, 3, 2 if scale == "down" else 1, bias=not norm)
        self.norm = _Norm(cout) if norm else None

    def forward(self, x):
        if self.scale == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = self.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, 0.2) if self.relu else x


class ResidualBlock(nn.Module):
    """conv1 (BN + LeakyReLU) → conv2 (BN) plus the shortcut (identity, or a
    plain scaled conv); no activation after the add."""

    def __init__(self, cin: int, cout: int, scale: str = "none"):
        super().__init__()
        self.shortcut_func = None if scale == "none" and cin == cout else \
            ConvLayer(cin, cout, scale)
        first, second = {"down": ("none", "down"), "up": ("up", "none"),
                         "none": ("none", "none")}[scale]
        self.conv1 = ConvLayer(cin, cout, first, norm=True, relu=True)
        self.conv2 = ConvLayer(cout, cout, second, norm=True)

    def forward(self, x):
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        return identity + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    """Encoder, residual body (with a global residual), decoder: (B, 3, 512,
    512) in [-1, 1] → (segmentation logits (B, 19, 512, 512), image)."""

    def __init__(self, in_size: int = 512, out_size: int = 512, min_feat_size: int = 32,
                 base_ch: int = 64, num_classes: int = 19, res_depth: int = 10,
                 ch_range: Tuple[int, int] = (32, 256)):
        super().__init__()
        lo, hi = ch_range

        def clip(c):
            return max(lo, min(c, hi))

        min_feat = min(in_size, min_feat_size)
        head = base_ch
        enc = [ConvLayer(3, base_ch)]
        for _ in range(int(math.log2(in_size // min_feat))):
            enc.append(ResidualBlock(clip(head), clip(head * 2), "down"))
            head *= 2
        self.encoder = nn.Sequential(*enc)
        self.body = nn.Sequential(*[ResidualBlock(clip(head), clip(head))
                                    for _ in range(res_depth)])
        dec = []
        for _ in range(int(math.log2(out_size // min_feat))):
            dec.append(ResidualBlock(clip(head), clip(head // 2), "up"))
            head //= 2
        self.decoder = nn.Sequential(*dec)
        self.out_img_conv = ConvLayer(clip(head), 3)
        self.out_mask_conv = ConvLayer(clip(head), num_classes)

    def forward(self, x):
        feat = self.encoder(x)
        h = self.decoder(feat + self.body(feat))
        return self.out_mask_conv(h), self.out_img_conv(h)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, stride, ks // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """ResNet-18 block: relu(bn2(conv2(relu(bn1(conv1 x)))) + shortcut)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                        nn.BatchNorm2d(cout)) \
            if cin != cout or stride != 1 else None

    def forward(self, x):
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        x = self.layer1(F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1))
        f8 = self.layer2(x)
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


class AttentionRefinement(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(f32.mean(dim=(2, 3), keepdim=True))
        f32_up = self.conv_head32(_nearest(self.arm32(f32) + avg, f16.shape[2:]))
        f16_up = self.conv_head16(_nearest(self.arm16(f16) + f32_up, f8.shape[2:]))
        return f8, f16_up, f32_up


class FeatureFusion(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True))))
        return feat * torch.sigmoid(atten) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, num_class: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = nn.Conv2d(mid, num_class, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """(B, 3, H, W) normalised face → three segmentation logit maps at full
    resolution (main, from the 8-level, from the 16-level)."""

    def __init__(self, num_class: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, num_class)
        self.conv_out16 = BiSeNetOutput(128, 64, num_class)
        self.conv_out32 = BiSeNetOutput(128, 64, num_class)

    def forward(self, x):
        h, w = x.shape[2:]
        f8, f16_up, f32_up = self.cp(x)
        outs = (self.conv_out(self.ffm(f8, f16_up)), self.conv_out16(f16_up),
                self.conv_out32(f32_up))
        return tuple(F.interpolate(o.float(), (h, w), mode="bilinear", align_corners=True)
                     for o in outs)


FACE_CLASS_IDS = tuple(range(1, 14))  # skin .. lips: the face mask


class FaceParser:
    """Paste-back mask for ``FaceRestoreHelper``: the crop resized to 512²,
    parsed on `device` (the card unless asked otherwise; f32, TF32 off),
    the face classes' mask resized back. ``model_name`` as facelib's
    ``init_parsing_model``: 'parsenet' (the default) or 'bisenet'. Without
    a state dict the weights are seeded random (``init_random_``)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 model_name: str = "parsenet", device=None):
        from ..utils.convert import init_random_

        if model_name == "parsenet":
            self.model = ParseNet()
        elif model_name == "bisenet":
            self.model = BiSeNet()
        else:
            raise NotImplementedError(f"{model_name} is not implemented.")
        self.device = torch.device("cuda" if device is None else device)
        if state_dict is None:
            init_random_(self.model, 0)
        else:
            _load(self.model, state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def logits(self, x: np.ndarray) -> np.ndarray:
        """(512, 512, 3) f32 normalised → (512, 512, classes) logits."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device).permute(2, 0, 1)[None]
        with no_tf32(self.device):
            seg = self.model(t)[0]
        return seg[0].permute(1, 2, 0).float().cpu().numpy()

    def __call__(self, face_crop_rgb: np.ndarray) -> np.ndarray:
        import cv2

        size = face_crop_rgb.shape[0]
        x = cv2.resize(face_crop_rgb, (512, 512)).astype(np.float32) / 127.5 - 1.0
        labels = self.logits(x).argmax(-1)
        mask = np.isin(labels, FACE_CLASS_IDS).astype(np.float32)
        return cv2.resize(mask, (size, size))
