"""Face detection and 68-point landmarks: S3FD, the 2D-FAN, and the
detectors the face path plugs into ``ImageProcessor``.

Counterpart of ``latentsync_tpu/models/face_detection.py``. The networks
are convolutions, batch norms and pooling with no TPU kernel, so they run
as plain torch (cuDNN on the card) in NCHW; their state dicts use the
upstream layouts (the ``face_alignment`` package's 2DFAN4 names, and the
S3FD ``vgg.*`` / ``extras.*`` / ``loc.*`` / ``conf.*`` names), so a
``.pth`` loads as it is and ``utils/convert.py`` carries the JAX
package's parameter trees over. Box decoding and NMS stay on the host in
numpy, as in the reference; the FAN's heatmap decode runs on the device
and returns only the 68 coordinate pairs.

TF32. cuDNN may run f32 convolutions in TF32 on the card, and the decode's
quarter-pixel sign refinement flips on small heatmap differences; the FAN
forward turns TF32 off for its own convolutions only
(``chip_smoke.py``'s onboarding phase holds the card's landmarks against
the CPU's).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# box utilities (host)
# ---------------------------------------------------------------------------


def decode_boxes(loc: np.ndarray, priors: np.ndarray, variances=(0.1, 0.2)) -> np.ndarray:
    """SSD box decoding: offsets (cx, cy, w, h) → corner boxes."""
    centers = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.3) -> List[int]:
    """Greedy IoU non-maximum suppression."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-9)
        order = order[1:][iou <= thresh]
    return keep


# ---------------------------------------------------------------------------
# S3FD
# ---------------------------------------------------------------------------


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learned scale per channel."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = x.float().pow(2).sum(1, keepdim=True).sqrt() + 1e-10
        return (x / norm * self.weight[None, :, None, None]).to(x.dtype)


# the VGG trunk as the upstream ModuleList: conv (in, out) at these indices
_S3FD_VGG = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256),
             12: (256, 256), 14: (256, 256), 17: (256, 512), 19: (512, 512), 21: (512, 512),
             24: (512, 512), 26: (512, 512), 28: (512, 512)}
_S3FD_POOLS = (4, 9, 16, 23, 30)  # 16: the one ceil-mode pool


class S3FD(nn.Module):
    """S3FD: VGG16 trunk (fc6 atrous), extra layers, six detection scales.

    Input (B, 3, H, W), RGB minus the mean; returns per-scale
    (class logits, box regressions), NCHW, for decoding on the host."""

    def __init__(self):
        super().__init__()
        vgg: List[nn.Module] = []
        for i in range(35):
            if i in _S3FD_VGG:
                vgg.append(nn.Conv2d(*_S3FD_VGG[i], 3, padding=1))
            elif i in _S3FD_POOLS:
                vgg.append(nn.MaxPool2d(2, 2, ceil_mode=i == 16))
            elif i == 31:
                vgg.append(nn.Conv2d(512, 1024, 3, padding=6, dilation=6))  # fc6
            elif i == 33:
                vgg.append(nn.Conv2d(1024, 1024, 1))  # fc7
            else:
                vgg.append(nn.ReLU())
        self.vgg = nn.ModuleList(vgg)
        self.L2Norm3_3 = L2Norm(256, 10.0)
        self.L2Norm4_3 = L2Norm(512, 8.0)
        self.L2Norm5_3 = L2Norm(512, 5.0)
        self.extras = nn.ModuleList([nn.Conv2d(1024, 256, 1), nn.Conv2d(256, 512, 3, 2, 1),
                                     nn.Conv2d(512, 128, 1), nn.Conv2d(128, 256, 3, 2, 1)])
        chans = (256, 512, 512, 1024, 512, 256)
        self.loc = nn.ModuleList([nn.Conv2d(c, 4, 3, padding=1) for c in chans])
        self.conf = nn.ModuleList([nn.Conv2d(c, 4 if i == 0 else 2, 3, padding=1)
                                   for i, c in enumerate(chans)])

    def forward(self, x):
        sources = []
        h = x
        for i, layer in enumerate(self.vgg):
            h = layer(h)
            if i == 15:
                sources.append(self.L2Norm3_3(h))  # conv3_3
            elif i == 22:
                sources.append(self.L2Norm4_3(h))  # conv4_3
            elif i == 29:
                sources.append(self.L2Norm5_3(h))  # conv5_3
        sources.append(h)  # fc7
        for i, layer in enumerate(self.extras):
            h = F.relu(layer(h))
            if i % 2:
                sources.append(h)
        return ([c(s) for c, s in zip(self.conf, sources)],
                [b(s) for b, s in zip(self.loc, sources)])


def _module_device(device) -> torch.device:
    """The device a detector runs on: the card unless the caller asks for
    another one."""
    return torch.device("cuda" if device is None else device)


def no_tf32(device: torch.device):
    """cuDNN without TF32 for the duration, on a CUDA device (a no-op
    elsewhere): the detectors' f32 convolutions."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=False)


def _load(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a state dict; batch-norm step counters it lacks (the JAX
    package's trees have none) start at 0."""
    sd = dict(sd)
    for key, buf in model.state_dict().items():
        if key.endswith("num_batches_tracked") and key not in sd:
            sd[key] = torch.zeros_like(buf)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})


class S3FDDetector:
    """S3FD on the device, decoding on the host: anchors at strides 4..128,
    each 4 strides wide; scores over `conf_thresh`, then NMS."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], device=None):
        self.device = _module_device(device)
        self.model = S3FD()
        _load(self.model, state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def detect(self, image_rgb: np.ndarray, conf_thresh: float = 0.8) -> np.ndarray:
        mean = np.array([123.0, 117.0, 104.0], np.float32)
        x = torch.from_numpy(image_rgb.astype(np.float32) - mean).to(self.device)
        cls_outs, box_outs = self.model(x.permute(2, 0, 1)[None])
        dets = []
        for i, (cls, box) in enumerate(zip(cls_outs, box_outs)):
            stride = 4 * (2 ** i)
            cls = cls[0].permute(1, 2, 0).float().cpu().numpy()
            box = box[0].permute(1, 2, 0).float().cpu().numpy()
            if cls.shape[-1] == 4:  # max-out background on the first scale
                bg = cls[..., :3].max(axis=-1, keepdims=True)
                cls = np.concatenate([bg, cls[..., 3:]], axis=-1)
            prob = np.exp(cls) / np.exp(cls).sum(-1, keepdims=True)
            score = prob[..., 1]
            ys, xs = np.where(score > conf_thresh)
            for yy, xx in zip(ys, xs):
                anchor = np.array([(xx + 0.5) * stride, (yy + 0.5) * stride,
                                   stride * 4.0, stride * 4.0])
                decoded = decode_boxes(box[yy, xx][None], anchor[None])[0]
                dets.append(np.concatenate([decoded, [score[yy, xx]]]))
        if not dets:
            return np.zeros((0, 5), np.float32)
        dets = np.stack(dets)
        return dets[nms(dets[:, :4], dets[:, 4])]


# ---------------------------------------------------------------------------
# 2D-FAN (stacked hourglass, 68 landmarks)
# ---------------------------------------------------------------------------


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """FAN's pre-activation block: three BN-ReLU-conv steps to c/2, c/4,
    c/4 channels, concatenated, plus the input (through BN-ReLU-1×1 conv
    when the width changes)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = _conv3(cin, cout // 2)
        self.bn2 = nn.BatchNorm2d(cout // 2)
        self.conv2 = _conv3(cout // 2, cout // 4)
        self.bn3 = nn.BatchNorm2d(cout // 4)
        self.conv3 = _conv3(cout // 4, cout // 4)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(nn.BatchNorm2d(cin), nn.ReLU(),
                                            nn.Conv2d(cin, cout, 1, bias=False))

    def forward(self, x):
        y1 = self.conv1(F.relu(self.bn1(x)))
        y2 = self.conv2(F.relu(self.bn2(y1)))
        y3 = self.conv3(F.relu(self.bn3(y2)))
        skip = x if self.downsample is None else self.downsample(x)
        return torch.cat([y1, y2, y3], 1) + skip


class Hourglass(nn.Module):
    """Recursive hourglass: b1 at full size, 2×2 average pool, b2, the next
    level (b2_plus at the bottom), b3, nearest ×2 upsampling, sum."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module("b2_plus_1", ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _level(self, x, level: int):
        up1 = self._modules[f"b1_{level}"](x)
        low = self._modules[f"b2_{level}"](F.avg_pool2d(x, 2, 2))
        low = self._level(low, level - 1) if level > 1 else self._modules["b2_plus_1"](low)
        low = self._modules[f"b3_{level}"](low)
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._level(x, self.depth)


class FAN2D(nn.Module):
    """2D-FAN 68-landmark heatmap regressor: (B, 3, 256, 256) in [0, 1] →
    one (B, 68, 64, 64) heatmap per stacked hourglass (the last is used).
    `num_modules` / `features` default to 2DFAN4; the packaged fallback is
    a one-module, 128-wide instance."""

    def __init__(self, num_modules: int = 4, features: int = 256):
        super().__init__()
        self.num_modules = num_modules
        f = features
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, f // 2)
        self.conv3 = ConvBlock(f // 2, f // 2)
        self.conv4 = ConvBlock(f // 2, f)
        for m in range(num_modules):
            self.add_module(f"m{m}", Hourglass(4, f))
            self.add_module(f"top_m_{m}", ConvBlock(f, f))
            self.add_module(f"conv_last{m}", nn.Conv2d(f, f, 1))
            self.add_module(f"bn_end{m}", nn.BatchNorm2d(f))
            self.add_module(f"l{m}", nn.Conv2d(f, 68, 1))
            if m < num_modules - 1:
                self.add_module(f"bl{m}", nn.Conv2d(f, f, 1))
                self.add_module(f"al{m}", nn.Conv2d(68, f, 1))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.avg_pool2d(self.conv2(h), 2, 2)
        prev = self.conv4(self.conv3(h))
        outputs = []
        for m in range(self.num_modules):
            ll = self._modules[f"top_m_{m}"](self._modules[f"m{m}"](prev))
            ll = F.relu(self._modules[f"bn_end{m}"](self._modules[f"conv_last{m}"](ll)))
            heat = self._modules[f"l{m}"](ll)
            outputs.append(heat)
            if m < self.num_modules - 1:
                prev = prev + self._modules[f"bl{m}"](ll) + self._modules[f"al{m}"](heat)
        return outputs


def decode_heatmaps_device(heat: torch.Tensor, scale: float = 4.0) -> torch.Tensor:
    """(N, K, H, W) heatmaps → (N, K, 2) sub-pixel argmax coordinates in
    input pixels, on the heatmaps' device: the first maximum of each map,
    ±0.25 px towards the larger neighbour at interior points only."""
    n, k, h, w = heat.shape
    flat = heat.reshape(n, k, h * w)
    idx = flat.argmax(-1)
    ys, xs = idx // w, idx % w
    xc, yc = xs.clamp(1, w - 2), ys.clamp(1, h - 2)

    def at(y, x):
        return flat.gather(-1, (y * w + x)[..., None])[..., 0]

    interior = (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
    dx = torch.sign(at(yc, xc + 1) - at(yc, xc - 1)) * 0.25
    dy = torch.sign(at(yc + 1, xc) - at(yc - 1, xc)) * 0.25
    coords = torch.stack([xs, ys], -1).float()
    coords = coords + torch.where(interior[..., None], torch.stack([dx, dy], -1).float(), 0.0)
    return (coords + 0.5) * scale


class HaarBoxDetector:
    """The face-box stage without checkpoints: the Haar anchor detector's
    box (cascade or static), widened to the full-head framing with margin
    the fallback FAN was trained on, behind ``.detect(image) → (N, 5)``."""

    def __init__(self):
        from ..utils.face import HaarAnchorDetector

        self._haar = HaarAnchorDetector()

    def detect(self, image_rgb: np.ndarray) -> np.ndarray:
        x, y, w, h = self._haar._detect_box(image_rgb)
        cx, cy = x + w / 2.0, y + h / 2.0
        half = max(w, h) * 0.72
        return np.array([[cx - half, cy - half * 1.05, cx + half, cy + half * 0.95, 1.0]],
                        np.float32)


def fan_shape(state_dict: Dict[str, torch.Tensor]):
    """(num_modules, features) of a FAN state dict."""
    heads = [k for k in state_dict if re.fullmatch(r"conv_last\d+\.weight", k)]
    return len(heads), int(state_dict["conv_last0.weight"].shape[0])


class FANLandmarkDetector:
    """68-landmark source for ``ImageProcessor``: face box (a detector's, or
    the whole frame) → 256² crop → FAN heatmaps → landmarks.

    The architecture comes from the state dict, so one class serves 2DFAN4
    weights and the packaged one-module fallback. Crops go to the device
    as uint8 in chunks of at most 128, and only the decoded coordinates
    come back."""

    CHUNK = 128

    def __init__(self, fan_state: Dict[str, torch.Tensor], face_detector=None, device=None):
        self.device = _module_device(device)
        self.model = FAN2D(*fan_shape(fan_state))
        _load(self.model, fan_state)
        self.model.to(self.device).eval()
        self.face_detector = face_detector

    def _no_tf32(self):
        """cuDNN without TF32, for the FAN's convolutions only."""
        return no_tf32(self.device)

    @torch.inference_mode()
    def landmarks(self, crops_u8: np.ndarray) -> np.ndarray:
        """(N, 256, 256, 3) uint8 crops → (N, 68, 2) crop-space landmarks."""
        out = np.empty((len(crops_u8), 68, 2), np.float32)
        for i in range(0, len(crops_u8), self.CHUNK):
            x = torch.from_numpy(np.ascontiguousarray(crops_u8[i:i + self.CHUNK]))
            x = x.to(self.device).permute(0, 3, 1, 2).float() / 255.0
            with self._no_tf32():
                heat = self.model(x)[-1]
            out[i:i + len(x)] = decode_heatmaps_device(heat).cpu().numpy()
        return out

    def _crop_box(self, image_rgb: np.ndarray):
        h, w = image_rgb.shape[:2]
        x1, y1, x2, y2 = 0, 0, w, h
        if self.face_detector is not None:
            dets = self.face_detector.detect(image_rgb)
            if len(dets):
                x1, y1, x2, y2 = dets[0][:4]
        return max(int(x1), 0), max(int(y1), 0), min(int(x2), w), min(int(y2), h)

    def _pass(self, images, boxes) -> np.ndarray:
        import cv2

        crops = np.stack([cv2.resize(img[y1:y2, x1:x2], (256, 256))
                          for img, (x1, y1, x2, y2) in zip(images, boxes)])
        lms = self.landmarks(crops)
        for lm, (x1, y1, x2, y2) in zip(lms, boxes):
            lm[:, 0] = lm[:, 0] * (x2 - x1) / 256.0 + x1
            lm[:, 1] = lm[:, 1] * (y2 - y1) / 256.0 + y1
        return lms

    def detect_batch(self, images) -> np.ndarray:
        """Landmarks of a whole clip in two passes. Pass 1 runs on at most 16
        frames (a stride subsample) cropped at the box stage's boxes; the
        median of their landmark boxes, widened to the head with margin,
        is the crop of pass 2 for every frame (one face a clip). A
        degenerate consensus box falls back to per-frame boxes."""
        n = len(images)
        sub = list(range(0, n, max(1, n // 16)))[:16]
        sub_imgs = [images[i] for i in sub]
        lms = self._pass(sub_imgs, [self._crop_box(img) for img in sub_imgs])
        per = np.stack([[lm[:, 0].min(), lm[:, 1].min(), lm[:, 0].max(), lm[:, 1].max()]
                        for lm in lms])
        x1, y1 = np.median(per[:, 0]), np.median(per[:, 1])
        x2, y2 = np.median(per[:, 2]), np.median(per[:, 3])
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        half = max(x2 - x1, y2 - y1) * 0.62
        h_img, w_img = images[0].shape[:2]
        rx1, rx2 = int(max(cx - half, 0)), int(min(cx + half, w_img))
        ry1, ry2 = int(max(cy - half * 1.1, 0)), int(min(cy + half * 0.9, h_img))
        if rx2 - rx1 > 16 and ry2 - ry1 > 16:
            return self._pass(images, [(rx1, ry1, rx2, ry2)] * n)
        return self._pass(images, [self._crop_box(img) for img in images])

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        return self.detect_batch([image_rgb])[0]


def init_detection_model(model_name: str, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                         device=None):
    """The reference's detector factory by name: ``retinaface_resnet50`` (the
    restoration default), ``retinaface_mobile0.25``, ``YOLOv5l`` and
    ``YOLOv5n``. Returns an object whose ``detect(image_rgb)`` gives (N, 15)
    rows [x1, y1, x2, y2, conf, 5 · (lx, ly)]; without a state dict its
    weights are seeded random."""
    if model_name in ("retinaface_resnet50", "retinaface_mobile0.25"):
        from .retinaface import RetinaFaceDetector

        return RetinaFaceDetector(state_dict, network=model_name, device=device)
    if model_name in ("YOLOv5l", "YOLOv5n"):
        from .yolov5face import YOLOv5FaceDetector

        return YOLOv5FaceDetector(state_dict, network=model_name, device=device)
    raise NotImplementedError(f"{model_name} is not implemented.")
