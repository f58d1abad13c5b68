"""RetinaFace face detector (MobileNet0.25 and ResNet50 backbones).

Counterpart of ``latentsync_tpu/models/retinaface.py`` (facelib's
``retinaface.py`` / ``retinaface_net.py``): a backbone, a three-level FPN,
SSH context modules and per-level class / box / landmark heads over two
anchors, then SSD decoding against prior boxes and NMS on the host. The
state dicts keep facelib's layout (``body.*``, ``fpn.output{N}`` /
``fpn.merge{N}``, ``ssh{N}.conv3X3`` ..., ``ClassHead.{i}.conv1x1``), so
``mobilenet0.25_Final.pth`` and ``detection_Resnet50_Final.pth`` load as
they are; ``utils/convert.py`` ``retinaface_state_dict_from_flax`` carries
the JAX package's variables across. The FPN's nearest upsampling samples
at pixel centres, as ``jax.image.resize`` does (torch's ``nearest-exact``).
Convolutions and batch norms only, plain torch (cuDNN on the card), f32.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .face_detection import _load, decode_boxes, nms, no_tf32


def conv_bn(cin: int, cout: int, stride: int = 1, leaky: float = 0.0) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False), nn.BatchNorm2d(cout),
                         nn.LeakyReLU(leaky))


def conv_bn1x1(cin: int, cout: int, leaky: float = 0.0) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, 1, 0, bias=False), nn.BatchNorm2d(cout),
                         nn.LeakyReLU(leaky))


def conv_bn_no_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout))


def conv_dw(cin: int, cout: int, stride: int, leaky: float = 0.1) -> nn.Sequential:
    """Depthwise-separable block: 0 dw conv, 1 bn, 3 pw conv, 4 bn."""
    return nn.Sequential(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
                         nn.BatchNorm2d(cin), nn.LeakyReLU(leaky),
                         nn.Conv2d(cin, cout, 1, 1, 0, bias=False), nn.BatchNorm2d(cout),
                         nn.LeakyReLU(leaky))


def upsample_to(x, size):
    """Nearest resize sampling at pixel centres (``jax.image.resize``)."""
    return F.interpolate(x, size=size, mode="nearest-exact")


class SSH(nn.Module):
    """Context module: 3x3, 5x5 and 7x7 receptive branches; LeakyReLU(0.1) up
    to 64 channels, ReLU above (facelib's ``leaky`` rule)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        leaky = 0.1 if cout <= 64 else 0.0
        self.conv3X3 = conv_bn_no_relu(cin, cout // 2)
        self.conv5X5_1 = conv_bn(cin, cout // 4, leaky=leaky)
        self.conv5X5_2 = conv_bn_no_relu(cout // 4, cout // 4)
        self.conv7X7_2 = conv_bn(cout // 4, cout // 4, leaky=leaky)
        self.conv7x7_3 = conv_bn_no_relu(cout // 4, cout // 4)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], dim=1))


class FPN(nn.Module):
    def __init__(self, chans, cout: int, leaky: float):
        super().__init__()
        self.output1 = conv_bn1x1(chans[0], cout, leaky)
        self.output2 = conv_bn1x1(chans[1], cout, leaky)
        self.output3 = conv_bn1x1(chans[2], cout, leaky)
        self.merge1 = conv_bn(cout, cout, leaky=leaky)
        self.merge2 = conv_bn(cout, cout, leaky=leaky)

    def forward(self, c1, c2, c3):
        o1, o2, o3 = self.output1(c1), self.output2(c2), self.output3(c3)
        o2 = self.merge2(o2 + upsample_to(o3, o2.shape[2:]))
        o1 = self.merge1(o1 + upsample_to(o2, o1.shape[2:]))
        return o1, o2, o3


class MobileNetBody(nn.Module):
    """MobileNet0.25: stride-8, -16 and -32 outputs of 64, 128, 256 channels."""

    def __init__(self):
        super().__init__()
        self.stage1 = nn.Sequential(conv_bn(3, 8, 2, leaky=0.1), conv_dw(8, 16, 1),
                                    conv_dw(16, 32, 2), conv_dw(32, 32, 1), conv_dw(32, 64, 2),
                                    conv_dw(64, 64, 1))
        self.stage2 = nn.Sequential(conv_dw(64, 128, 2), *[conv_dw(128, 128, 1) for _ in range(5)])
        self.stage3 = nn.Sequential(conv_dw(128, 256, 2), conv_dw(256, 256, 1))

    def forward(self, x):
        c1 = self.stage1(x)
        c2 = self.stage2(c1)
        return c1, c2, self.stage3(c2)


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (stride on the 3x3)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                        nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet50Body(nn.Module):
    """torchvision resnet50 to layer4: the outputs of layers 2, 3 and 4."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, blocks, stride) in enumerate([(64, 3, 1), (128, 4, 2), (256, 6, 2),
                                                      (512, 3, 2)]):
            layer = [Bottleneck(cin, planes, stride, True)]
            cin = planes * 4
            layer += [Bottleneck(cin, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        c1 = self.layer2(self.layer1(x))
        c2 = self.layer3(c1)
        return c1, c2, self.layer4(c2)


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv1x1(x)


class RetinaFace(nn.Module):
    """Input (B, 3, H, W) BGR minus the BGR means; returns per level (class
    (B, 4, h, w), box (B, 8, h, w), landmarks (B, 20, h, w))."""

    def __init__(self, network: str = "mobile0.25"):
        super().__init__()
        if network == "mobile0.25":
            self.body, chans, out, leaky = MobileNetBody(), (64, 128, 256), 64, 0.1
        elif network == "resnet50":
            self.body, chans, out, leaky = ResNet50Body(), (512, 1024, 2048), 256, 0.0
        else:
            raise ValueError(f"unknown RetinaFace network {network!r}")
        self.fpn = FPN(chans, out, leaky)
        self.ssh1, self.ssh2, self.ssh3 = SSH(out, out), SSH(out, out), SSH(out, out)
        self.ClassHead = nn.ModuleList([_Head(out, 4) for _ in range(3)])
        self.BboxHead = nn.ModuleList([_Head(out, 8) for _ in range(3)])
        self.LandmarkHead = nn.ModuleList([_Head(out, 20) for _ in range(3)])

    def forward(self, x):
        p = self.fpn(*self.body(x))
        feats = [self.ssh1(p[0]), self.ssh2(p[1]), self.ssh3(p[2])]
        return [(self.ClassHead[i](f), self.BboxHead[i](f), self.LandmarkHead[i](f))
                for i, f in enumerate(feats)]


def prior_boxes(image_hw: Tuple[int, int]) -> np.ndarray:
    """Anchor priors (cx, cy, w, h) relative to the image: strides 8, 16, 32,
    two sizes a level."""
    h, w = image_hw
    min_sizes = [[16, 32], [64, 128], [256, 512]]
    anchors = []
    for k, step in enumerate((8, 16, 32)):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i, j in itertools.product(range(fh), range(fw)):
            for ms in min_sizes[k]:
                anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h, ms / w, ms / h])
    return np.asarray(anchors, np.float32)


def _module_device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


class RetinaFaceDetector:
    """``detect(image_rgb)`` → (N, 15) rows: box (4), score, 5 landmarks (10),
    in pixels. The net runs on `device` (the card unless asked otherwise)
    in f32 with TF32 off; decoding and NMS on the host. Without a state
    dict the weights are seeded random (``init_random_``)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 network: str = "mobile0.25", device=None):
        from ..utils.convert import init_random_

        self.device = _module_device(device)
        self.model = RetinaFace(network.replace("retinaface_", ""))
        if state_dict is None:
            init_random_(self.model, 0)
        else:
            _load(self.model, state_dict)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def forward(self, image_rgb: np.ndarray):
        """The net's per-level outputs, each (N, channels) in anchor order."""
        mean = np.array([104.0, 117.0, 123.0], np.float32)  # BGR means
        x = image_rgb[..., ::-1].astype(np.float32) - mean
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device).permute(2, 0, 1)[None]
        with no_tf32(self.device):
            outs = self.model(x)
        return [tuple(t[0].permute(1, 2, 0).float().cpu().numpy() for t in level)
                for level in outs]

    def detect(self, image_rgb: np.ndarray, conf_thresh: float = 0.8,
               nms_thresh: float = 0.4) -> np.ndarray:
        h, w = image_rgb.shape[:2]
        outs = self.forward(image_rgb)
        scores_raw = np.concatenate([c.reshape(-1, 2) for c, _, _ in outs])
        loc = np.concatenate([b.reshape(-1, 4) for _, b, _ in outs])
        ldm = np.concatenate([l.reshape(-1, 10) for _, _, l in outs])
        priors = prior_boxes((h, w))
        n = min(len(priors), len(loc))
        priors, loc, ldm, scores_raw = priors[:n], loc[:n], ldm[:n], scores_raw[:n]
        e = np.exp(scores_raw - scores_raw.max(-1, keepdims=True))
        scores = (e / e.sum(-1, keepdims=True))[:, 1]
        boxes = decode_boxes(loc, priors) * np.array([w, h, w, h], np.float32)
        keep = scores > conf_thresh
        if not keep.any():
            return np.zeros((0, 15), np.float32)
        boxes, scores, ldm, priors = boxes[keep], scores[keep], ldm[keep], priors[keep]
        pts = priors[:, None, :2] + ldm.reshape(-1, 5, 2) * 0.1 * priors[:, None, 2:]
        pts = (pts * np.array([w, h], np.float32)).reshape(-1, 10)
        dets = np.concatenate([boxes, scores[:, None], pts], axis=1)
        return dets[nms(dets[:, :4], dets[:, 4], nms_thresh)]
