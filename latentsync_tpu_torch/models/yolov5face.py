"""YOLOv5-face detectors (yolov5n-face and yolov5l-face).

Counterpart of ``latentsync_tpu/models/yolov5face.py`` (facelib's
``yolov5face``: ``models/common.py`` Conv / StemBlock / ShuffleV2Block / C3
/ SPP, the ``yolov5n.yaml`` and ``yolov5l.yaml`` layer plans, ``yolo.py``
Detect, ``face_detector.py``): the net and its grid / anchor decode on the
device, letterbox and NMS on the host. Each face is (x1, y1, x2, y2, conf,
5 landmark points). The state dicts keep the upstream ``model.{i}.*``
layout; ``utils/convert.py`` ``yolov5face_state_dict_from_flax`` carries the
JAX package's variables across. Plain torch (cuDNN on the card), f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .face_detection import _load, no_tf32

ANCHORS = np.array([
    [[4, 5], [8, 10], [13, 16]],
    [[23, 29], [43, 55], [73, 105]],
    [[146, 217], [231, 300], [335, 433]],
], np.float32)
STRIDES = (8, 16, 32)


class Conv(nn.Module):
    """conv (no bias) + BN + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class StemBlock(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.stem_1 = Conv(c1, c2, 3, 2)
        self.stem_2a = Conv(c2, c2 // 2, 1, 1)
        self.stem_2b = Conv(c2 // 2, c2, 3, 2)
        self.stem_3 = Conv(c2 * 2, c2, 1, 1)

    def forward(self, x):
        s1 = self.stem_1(x)
        pooled = F.max_pool2d(s1, 2, 2, ceil_mode=True)
        return self.stem_3(torch.cat([self.stem_2b(self.stem_2a(s1)), pooled], 1))


def channel_shuffle(x, groups: int = 2):
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


class ShuffleV2Block(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2d(inp, inp, 3, stride, 1, groups=inp, bias=False), nn.BatchNorm2d(inp),
                nn.Conv2d(inp, bf, 1, bias=False), nn.BatchNorm2d(bf), nn.SiLU())
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            nn.Conv2d(inp if stride > 1 else bf, bf, 1, bias=False), nn.BatchNorm2d(bf),
            nn.SiLU(), nn.Conv2d(bf, bf, 3, stride, 1, groups=bf, bias=False),
            nn.BatchNorm2d(bf), nn.Conv2d(bf, bf, 1, bias=False), nn.BatchNorm2d(bf), nn.SiLU())

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 1)
        self.cv2 = Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*[Bottleneck(c_, shortcut) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    def __init__(self, c1: int, c2: int, ks=(3, 5, 7)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * (len(ks) + 1), c2, 1)
        self.ks = ks

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.ks], 1))


class Detect(nn.Module):
    def __init__(self, chans, no: int = 16):
        super().__init__()
        self.m = nn.ModuleList([nn.Conv2d(c, 3 * no, 1) for c in chans])


def decode_level(p, li: int):
    """One level's raw head output (B, 3 · 16, ny, nx) → (B, ny · nx · 3, 16):
    centre / size / conf / 10 landmark coordinates / class, in pixels, rows
    in (y, x, anchor) order."""
    b, _, ny, nx = p.shape
    p = p.float().view(b, 3, 16, ny, nx).permute(0, 3, 4, 1, 2)   # (B, ny, nx, 3, 16)
    yv, xv = torch.meshgrid(torch.arange(ny, device=p.device, dtype=torch.float32),
                            torch.arange(nx, device=p.device, dtype=torch.float32), indexing="ij")
    grid = torch.stack([xv, yv], -1)[None, :, :, None, :]
    anchor = torch.from_numpy(ANCHORS[li]).to(p.device)[None, None, None]
    stride = float(STRIDES[li])
    xy = (torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5 + grid) * stride
    wh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * anchor
    conf = torch.sigmoid(p[..., 4:5])
    lmk = p[..., 5:15].reshape(b, ny, nx, 3, 5, 2) * anchor[..., None, :] \
        + grid[..., None, :] * stride
    out = torch.cat([xy, wh, conf, lmk.reshape(b, ny, nx, 3, 10), torch.sigmoid(p[..., 15:])],
                    -1)
    return out.reshape(b, ny * nx * 3, 16)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv5Face(nn.Module):
    """Input (B, 3, H, W) RGB in [0, 1] (H, W multiples of 32) → decoded
    (B, N, 16)."""

    def __init__(self, network: str = "yolov5n"):
        super().__init__()
        self.network = network.lower()
        if self.network == "yolov5n":
            m = {"0": StemBlock(3, 32), "1": ShuffleV2Block(32, 128, 2),
                 "2": nn.Sequential(*[ShuffleV2Block(128, 128, 1) for _ in range(3)]),
                 "3": ShuffleV2Block(128, 256, 2),
                 "4": nn.Sequential(*[ShuffleV2Block(256, 256, 1) for _ in range(7)]),
                 "5": ShuffleV2Block(256, 512, 2),
                 "6": nn.Sequential(*[ShuffleV2Block(512, 512, 1) for _ in range(3)]),
                 "7": Conv(512, 128, 1), "10": C3(384, 128, 1, False), "11": Conv(128, 128, 1),
                 "14": C3(256, 128, 1, False), "15": Conv(128, 128, 3, 2),
                 "17": C3(256, 128, 1, False), "18": Conv(128, 128, 3, 2),
                 "20": C3(256, 128, 1, False), "21": Detect((128, 128, 128))}
        elif self.network == "yolov5l":
            m = {"0": StemBlock(3, 64), "1": C3(64, 128, 3), "2": Conv(128, 256, 3, 2),
                 "3": C3(256, 256, 9), "4": Conv(256, 512, 3, 2), "5": C3(512, 512, 9),
                 "6": Conv(512, 1024, 3, 2), "7": SPP(1024, 1024), "8": C3(1024, 1024, 3, False),
                 "9": Conv(1024, 512, 1), "12": C3(1024, 512, 3, False), "13": Conv(512, 256, 1),
                 "16": C3(512, 256, 3, False), "17": Conv(256, 256, 3, 2),
                 "19": C3(512, 512, 3, False), "20": Conv(512, 512, 3, 2),
                 "22": C3(1024, 1024, 3, False), "23": Detect((256, 512, 1024))}
        else:
            raise ValueError(f"unknown YOLOv5-face network {network!r}")
        self.model = nn.ModuleDict(m)

    def heads(self, x):
        """The three levels' raw head outputs."""
        M = self.model
        if self.network == "yolov5n":
            y2 = M["2"](M["1"](M["0"](x)))
            y4 = M["4"](M["3"](y2))
            y7 = M["7"](M["6"](M["5"](y4)))
            y11 = M["11"](M["10"](torch.cat([_up(y7), y4], 1)))
            p3 = M["14"](torch.cat([_up(y11), y2], 1))
            p4 = M["17"](torch.cat([M["15"](p3), y11], 1))
            p5 = M["20"](torch.cat([M["18"](p4), y7], 1))
            detect = M["21"]
        else:
            y3 = M["3"](M["2"](M["1"](M["0"](x))))
            y5 = M["5"](M["4"](y3))
            y9 = M["9"](M["8"](M["7"](M["6"](y5))))
            y13 = M["13"](M["12"](torch.cat([_up(y9), y5], 1)))
            p3 = M["16"](torch.cat([_up(y13), y3], 1))
            p4 = M["19"](torch.cat([M["17"](p3), y13], 1))
            p5 = M["22"](torch.cat([M["20"](p4), y9], 1))
            detect = M["23"]
        return [conv(f) for conv, f in zip(detect.m, (p3, p4, p5))]

    def forward(self, x):
        return torch.cat([decode_level(p, li) for li, p in enumerate(self.heads(x))], 1)


def _nms_face(pred: np.ndarray, conf_thres=0.25, iou_thres=0.45, max_det=300) -> np.ndarray:
    """facelib's ``non_max_suppression_face`` for one image: (N, 16) centre /
    size / conf / landmarks / class → (M, 16) corners / conf / landmarks /
    class."""
    pred = pred[pred[:, 4] > conf_thres]
    if not len(pred):
        return np.zeros((0, 16), np.float32)
    boxes = np.empty_like(pred[:, :4])
    boxes[:, 0] = pred[:, 0] - pred[:, 2] / 2
    boxes[:, 1] = pred[:, 1] - pred[:, 3] / 2
    boxes[:, 2] = pred[:, 0] + pred[:, 2] / 2
    boxes[:, 3] = pred[:, 1] + pred[:, 3] / 2
    scores = pred[:, 4] * pred[:, 15]
    order = scores.argsort()[::-1][: max_det * 4]
    boxes, pred = boxes[order], pred[order]
    keep = []
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    idxs = np.arange(len(boxes))
    while len(idxs):
        i = idxs[0]
        keep.append(i)
        if len(keep) >= max_det:
            break
        xx1 = np.maximum(boxes[i, 0], boxes[idxs[1:], 0])
        yy1 = np.maximum(boxes[i, 1], boxes[idxs[1:], 1])
        xx2 = np.minimum(boxes[i, 2], boxes[idxs[1:], 2])
        yy2 = np.minimum(boxes[i, 3], boxes[idxs[1:], 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / (areas[i] + areas[idxs[1:]] - inter + 1e-9)
        idxs = idxs[1:][iou <= iou_thres]
    out = np.concatenate([boxes[keep], pred[keep, 4:5], pred[keep, 5:15], pred[keep, 15:16]],
                         axis=1)
    return out.astype(np.float32)


class YOLOv5FaceDetector:
    """``detect(image_rgb)`` → (M, 15) [x1, y1, x2, y2, conf, 5 · (lx, ly)]:
    letterbox into an `img_size` square of grey 114, the net on `device` (the
    card unless asked otherwise) in f32 with TF32 off, NMS and rescale on the
    host; faces narrower than `min_face` dropped. Without a state dict the
    weights are seeded random (``init_random_``)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 img_size: int = 640, min_face: int = 10, network: str = "YOLOv5n",
                 device=None):
        from ..utils.convert import init_random_

        self.device = torch.device("cuda" if device is None else device)
        self.model = YOLOv5Face(network)
        if state_dict is None:
            init_random_(self.model, 0)
        else:
            _load(self.model, state_dict)
        self.model.to(self.device).eval()
        self.img_size, self.min_face = img_size, min_face

    @torch.inference_mode()
    def predict(self, canvas_u8: np.ndarray) -> np.ndarray:
        """The decoded net output (N, 16) of one letterboxed uint8 image."""
        x = torch.from_numpy(canvas_u8.astype(np.float32) / 255.0).to(self.device)
        with no_tf32(self.device):
            return self.model(x.permute(2, 0, 1)[None])[0].float().cpu().numpy()

    def detect(self, image_rgb: np.ndarray, conf_thres=0.25, iou_thres=0.45) -> np.ndarray:
        import cv2

        h0, w0 = image_rgb.shape[:2]
        s = self.img_size / max(h0, w0)
        nh, nw = int(round(h0 * s)), int(round(w0 * s))
        canvas = np.full((self.img_size, self.img_size, 3), 114, np.uint8)
        canvas[:nh, :nw] = cv2.resize(image_rgb, (nw, nh))
        dets = _nms_face(self.predict(canvas), conf_thres, iou_thres)
        if len(dets):
            dets[:, :4] /= s
            dets[:, 5:15] /= s
            dets = dets[(dets[:, 2] - dets[:, 0]) >= self.min_face]
        return dets[:, :15]
