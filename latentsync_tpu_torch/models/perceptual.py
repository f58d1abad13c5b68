"""VGG16 features and LPIPS, the stage-2 trainer's perceptual loss.

Counterpart of ``latentsync_tpu/models/perceptual.py`` ``VGG16Features``
and ``LPIPS`` (ref:scripts/train_unet.py:209, :372-377: lpips.LPIPS(net='vgg')
on the lower face half). Layout is NCHW; the backbone keeps torchvision's
``vgg16().features`` numbering (``vgg.features.N``) and the heads the lpips
package's (``lins.N.model.1``), the layouts
``convert_vgg16_torchvision`` and ``convert_lpips`` read. The feature
differences and the 1×1 heads run in f32, as the JAX model's f32 heads do.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg16 conv plan: channels per conv, "M" = 2×2 max pool
VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
# LPIPS taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (0-based conv index)
LPIPS_TAP_CONVS = (1, 3, 6, 9, 12)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """forward(x (B, 3, H, W) in [-1, 1]) → the five LPIPS tap activations."""

    def __init__(self):
        super().__init__()
        layers, ch = [], 3
        for spec in VGG16_PLAN[:-1]:  # the last pool feeds no tap
            if spec == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(ch, spec, 3, padding=1), nn.ReLU()]
                ch = spec
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        dt = self.features[0].weight.dtype
        shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
        x = ((x.float() - shift) / scale).to(dt)
        taps, conv = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                if conv in LPIPS_TAP_CONVS:
                    taps.append(x)
                conv += 1
        return taps


class LPIPS(nn.Module):
    """forward(x, y (B, 3, H, W) in [-1, 1]) → (B,) f32: unit-normalised
    feature differences squared, 1×1 heads, spatial means, summed over the
    five taps. H and W of at least 16 keep a pixel at the last tap."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        chans = [c for i, c in enumerate(c for c in VGG16_PLAN if c != "M")
                 if i in LPIPS_TAP_CONVS]
        self.lins = nn.ModuleList()
        for c in chans:
            head = nn.Module()
            head.model = nn.Sequential(nn.Dropout(0.0), nn.Conv2d(c, 1, 1, bias=False))
            self.lins.append(head)

    def forward(self, x, y):
        total = 0.0
        for a, b, head in zip(self.vgg(x), self.vgg(y), self.lins):
            a = a / torch.clamp(torch.linalg.vector_norm(a.float(), dim=1, keepdim=True),
                                min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b.float(), dim=1, keepdim=True),
                                min=1e-10)
            d = (a - b) ** 2
            w = F.conv2d(d, head.model[1].weight.to(d.dtype))
            total = total + w.mean(dim=(1, 2, 3))
        return total
