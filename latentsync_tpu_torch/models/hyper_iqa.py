"""HyperIQA: no-reference image quality, the preprocess quality gate.

Counterpart of ``latentsync_tpu/models/hyper_iqa.py`` (ref:eval/hyper_iqa.py
HyperNet + TargetNet): a ResNet50 backbone; local-distortion heads pool
three early stages into a 224-d target vector; a hyper head over the 7×7
C5 map predicts the weights of a small per-image MLP (TargetNet: 224 → 112
→ 56 → 28 → 14 with sigmoid gates, then a dot product) that maps the vector
to a quality score. The data pipeline's quality gate keeps clips scoring 40
and over (ref:preprocess/filter_visual_quality.py:57).

The module names are upstream's (``koniq_pretrained.pkl``: ``res.layer1.0.
downsample.0``, ``res.lda1_pool.0``, ``conv1.4``, ``fc3w_conv``, ...), and so is
the local heads' flatten, NCHW: the JAX module flattens channels-last, and
``utils/convert.py`` ``hyperiqa_state_dict_from_flax`` permutes those
columns so that the port computes what the JAX module computes. NCHW, f32,
224² input (a 7×7 hyper map: ``FS2`` = 49), batch norms at eps 1e-5.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# the released operating point: TargetNet widths, the lda heads' output,
# the hyper map's channels and its 7×7 size at 224²
TARGET_DIMS = (224, 112, 56, 28, 14)
LDA_OUT, HYPER_IN, FS2 = 16, 112, 49
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet50Backbone(nn.Module):
    """ResNet50 with the three local-distortion heads and the C5 one
    (``lda4_fc``) of upstream's ``ResNetBackbone``."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]):
            layer = [Bottleneck(cin, planes, stride, downsample=True)]
            cin = planes * 4
            layer += [Bottleneck(cin, planes) for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        # the pooled maps of C2, C3, C4 (224² input: 8², 4², 2²) → LDA_OUT each
        for i, (cin, ch, side) in enumerate([(256, 16, 8), (512, 32, 4), (1024, 64, 2)]):
            self.add_module(f"lda{i + 1}_pool", nn.Sequential(
                nn.Conv2d(cin, ch, 1, bias=False), nn.AvgPool2d(7, 7)))
            self.add_module(f"lda{i + 1}_fc", nn.Linear(ch * side * side, LDA_OUT))
        self.lda4_fc = nn.Linear(2048, TARGET_DIMS[0] - 3 * LDA_OUT)

    def forward(self, x: torch.Tensor):
        """→ (C5 (B, 2048, 7, 7), target vector (B, 224))."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        vecs = []
        for i in range(1, 4):
            x = getattr(self, f"layer{i}")(x)
            h = getattr(self, f"lda{i}_pool")(x)
            vecs.append(getattr(self, f"lda{i}_fc")(h.reshape(h.shape[0], -1)))
        x = self.layer4(x)
        vecs.append(self.lda4_fc(x.mean(dim=(2, 3))))
        return x, torch.cat(vecs, 1)


class HyperIQA(nn.Module):
    """(B, 3, 224, 224) ImageNet-normalised → quality scores (B,) (higher is
    better, typically 0-100)."""

    def __init__(self):
        super().__init__()
        self.res = ResNet50Backbone()
        self.conv1 = nn.Sequential(
            nn.Conv2d(2048, 1024, 1), nn.ReLU(inplace=True),
            nn.Conv2d(1024, 512, 1), nn.ReLU(inplace=True),
            nn.Conv2d(512, HYPER_IN, 1), nn.ReLU(inplace=True))
        dims = TARGET_DIMS
        for i in range(4):
            self.add_module(f"fc{i + 1}w_conv",
                            nn.Conv2d(HYPER_IN, dims[i] * dims[i + 1] // FS2, 3, padding=1))
            self.add_module(f"fc{i + 1}b_fc", nn.Linear(HYPER_IN, dims[i + 1]))
        self.fc5w_fc = nn.Linear(HYPER_IN, dims[4])
        self.fc5b_fc = nn.Linear(HYPER_IN, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5, v = self.res(x)
        h = self.conv1(c5)  # (B, 112, 7, 7)
        pooled = h.mean(dim=(2, 3))
        b, dims = x.shape[0], TARGET_DIMS
        for i in range(4):
            # TargetNet weights: a 3×3 conv over the hyper map, channel-major
            w = getattr(self, f"fc{i + 1}w_conv")(h).reshape(b, dims[i + 1], dims[i])
            bias = getattr(self, f"fc{i + 1}b_fc")(pooled)
            v = torch.sigmoid(torch.einsum("boi,bi->bo", w, v) + bias)
        return (self.fc5w_fc(pooled) * v).sum(-1) + self.fc5b_fc(pooled)[:, 0]


def normalize_frames(frames_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB frames (N, H, W, 3) → (N, 3, 224, 224) f32 ImageNet-normalised,
    resized as the JAX scorer resizes (OpenCV, bilinear)."""
    import cv2

    mean, std = np.array(_MEAN, np.float32), np.array(_STD, np.float32)
    out = [(cv2.resize(f, (224, 224)).astype(np.float32) / 255.0 - mean) / std
           for f in frames_rgb]
    return np.ascontiguousarray(np.stack(out).transpose(0, 3, 1, 2))


class HyperIQAScorer:
    """Frame scorer of the quality gate: ``scorer(frame)`` → float, and
    ``scorer.score_batch(frames)`` → (N,) for many frames in one forward.
    `state_dict`: upstream layout, else seeded random weights (statistics
    included). f32 with TF32 off on the card, which it uses unless `device`
    says otherwise."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None, device=None):
        from ..utils.convert import init_random_bn_
        from .face_detection import _load, _module_device

        self.device = _module_device(device)
        self.model = HyperIQA()
        if state_dict is None:
            init_random_bn_(self.model, seed=0)
        else:
            _load(self.model, state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def score_batch(self, frames_rgb: np.ndarray) -> np.ndarray:
        from .face_detection import no_tf32

        x = torch.from_numpy(normalize_frames(frames_rgb)).to(self.device)
        with no_tf32(self.device):
            return self.model(x).float().cpu().numpy()

    def __call__(self, frame_rgb: np.ndarray) -> float:
        return float(self.score_batch(frame_rgb[None])[0])
