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


# ---------------------------------------------------------------------------
# FVD
# ---------------------------------------------------------------------------


def frechet_distance(feats_a, feats_b) -> float:
    """The FVD / FID statistic ||mu_a - mu_b||² + Tr(Ca + Cb - 2 (Ca Cb)^½) of
    two (N, D) feature sets, in float64 on the host (ref:eval/fvd.py:9-25;
    ``scipy.linalg.sqrtm`` of the covariance product, its real part)."""
    import numpy as np
    import scipy.linalg

    feats_a, feats_b = np.asarray(feats_a), np.asarray(feats_b)
    diff = feats_a.mean(0) - feats_b.mean(0)
    ca = np.cov(feats_a, rowvar=False)
    cb = np.cov(feats_b, rowvar=False)
    covmean = scipy.linalg.sqrtm(ca @ cb)
    if isinstance(covmean, tuple):  # SciPy releases that return (sqrtm, error)
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2 * np.trace(covmean))


class I3DFeatures(nn.Module):
    """The JAX package's minimal 3D-conv feature tower for FVD where no I3D
    weights exist: four 3×3×3 convolutions (64, 128, 256, 512 channels;
    strides (1,2,2) then (2,2,2)), each with GroupNorm (min(32, C/4) groups,
    eps 1e-6) and ReLU, a mean over space and time and a linear head.
    (B, 3, T, H, W) in [-1, 1] → (B, feature_dim)."""

    def __init__(self, feature_dim: int = 400):
        super().__init__()
        cin = 3
        for i, (ch, stride) in enumerate([(64, (1, 2, 2)), (128, (2, 2, 2)),
                                          (256, (2, 2, 2)), (512, (2, 2, 2))]):
            self.add_module(f"conv{i}", nn.Conv3d(cin, ch, 3, stride, 1))
            self.add_module(f"norm{i}", nn.GroupNorm(min(32, ch // 4), ch, eps=1e-6))
            cin = ch
        self.head = nn.Linear(512, feature_dim)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video
        for i in range(4):
            x = F.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
        return self.head(x.mean(dim=(2, 3, 4)))


def compute_fvd(feats_fake, feats_real) -> float:
    """ref:eval/fvd.py compute_our_fvd: the Fréchet distance of two feature
    sets (tensors or arrays)."""
    def host(f):
        return f.detach().float().cpu().numpy() if isinstance(f, torch.Tensor) else f

    return frechet_distance(host(feats_fake), host(feats_real))
