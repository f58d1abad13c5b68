"""Face geometry on the host: similarity alignment, landmark smoothing,
the align warp and its restore, and the Haar fallback landmark source.

Counterpart of ``latentsync_tpu/utils/face.py`` (numpy and OpenCV, the
same semantics): ``similarity_from_points``, ``LandmarkSmoother``,
``landmarks68_to_anchor3``, ``AlignRestore`` and ``HaarAnchorDetector``.
The reference's ``warp_affine_batch`` (the device warp of its restore
path) comes with the port's device restore.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import cv2
import numpy as np


def similarity_from_points(src: np.ndarray, dst: np.ndarray, smooth: bool = True,
                           prev_bias: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """2×3 similarity transform mapping `src` → `dst` points.

    Orthogonal Procrustes on standardised point sets; with `smooth`, the
    translation is nudged by an EMA of the standardised residual of the
    third (nose) point: bias = 0.2·prev + 0.8·cur. Degenerate anchors (all
    points at one place) give a pure translation at unit scale."""
    src = np.asarray(src, np.float64).copy()
    dst = np.asarray(dst, np.float64).copy()
    c1, c2 = src.mean(0), dst.mean(0)
    s1 = np.std(src - c1)
    s2 = np.std(dst - c2)
    if s1 < 1e-9 or s2 < 1e-9:
        m = np.array([[1.0, 0.0, c2[0] - c1[0]],
                      [0.0, 1.0, c2[1] - c1[1]]], np.float64)
        return m, (prev_bias if smooth else None)
    a = (src - c1) / s1
    b = (dst - c2) / s2
    u, _, vt = np.linalg.svd(a.T @ b)
    r = (u @ vt).T
    scale = s2 / s1
    m = np.empty((2, 3), np.float64)
    m[:, :2] = scale * r
    m[:, 2] = c2 - scale * (r @ c1)
    bias = None
    if smooth:
        cur = b[2] - a[2]
        bias = cur if prev_bias is None else prev_bias * 0.2 + cur * 0.8
        m[:, 2] += bias
    return m, bias


class LandmarkSmoother:
    """Exponential landmark smoothing weighted by each point's motion."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.prev: Optional[np.ndarray] = None

    def reset(self):
        self.prev = None

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, np.float64)
        if self.prev is None:
            self.prev = pts.copy()
            return pts.copy()
        width = pts[:, 0].max() - pts[:, 0].min()
        d2 = ((pts - self.prev) ** 2).sum(axis=1)
        w = np.exp(-d2 / (width * self.alpha))[:, None]
        out = self.prev * w + pts * (1 - w)
        self.prev = out.copy()
        return out


def landmarks68_to_anchor3(lm68: np.ndarray) -> np.ndarray:
    """68-point landmarks → the three alignment anchors: left-brow mean,
    right-brow mean, nose mean."""
    out = np.zeros((3, 2))
    out[0] = lm68[17:22].mean(0)
    out[1] = lm68[22:27].mean(0)
    out[2] = lm68[27:36].mean(0)
    return out


@dataclass
class AlignRestore:
    """The canonical face-crop geometry (ratio 2.8: a 210×280 crop)."""

    ratio: float = 2.8
    upscale_factor: float = 1.0
    prev_bias: Optional[np.ndarray] = None

    def __post_init__(self):
        template = np.array([[17.0, 20.0], [58.0, 20.0], [37.5, 40.0]])
        self.face_template = template * self.ratio
        self.face_size = (int(75 * self.ratio), int(100 * self.ratio))  # (w, h)

    def reset(self):
        self.prev_bias = None

    def align_warp_face(self, img: np.ndarray, anchor3: np.ndarray, smooth: bool = True,
                        border_value=(127, 127, 127)) -> Tuple[np.ndarray, np.ndarray]:
        """Warp the frame to the canonical crop: (face, 2×3 matrix)."""
        m, self.prev_bias = similarity_from_points(anchor3, self.face_template, smooth,
                                                   self.prev_bias)
        face = cv2.warpAffine(img, m, self.face_size, flags=cv2.INTER_LANCZOS4,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=border_value)
        return face, m

    def restore_img(self, frame: np.ndarray, face: np.ndarray,
                    affine_matrix: np.ndarray) -> np.ndarray:
        """Inverse-warp a face crop into the frame with an eroded and blurred
        soft mask over the pasted face's own extent."""
        h, w = frame.shape[:2]
        inv = cv2.invertAffineTransform(np.asarray(affine_matrix, np.float64))
        restored = cv2.warpAffine(face, inv, (w, h), flags=cv2.INTER_LANCZOS4)
        mask = np.ones(face.shape[:2], np.float32)
        inv_mask = cv2.warpAffine(mask, inv, (w, h))
        k = max(int(2 * self.upscale_factor), 1)
        inv_mask = cv2.erode(inv_mask, np.ones((k, k), np.uint8))
        area = inv_mask.sum()
        edge = int(area**0.5) // 20
        if edge > 0:
            center = cv2.erode(inv_mask, np.ones((edge * 2, edge * 2), np.uint8))
            soft = cv2.GaussianBlur(center, (edge * 2 + 1, edge * 2 + 1), 0)
        else:
            soft = inv_mask
        soft = soft[:, :, None]
        out = soft * (inv_mask[:, :, None] * restored) + (1 - soft) * frame
        return np.clip(out, 0, 255).astype(np.uint8)


class HaarAnchorDetector:
    """The landmark source of last resort: an OpenCV Haar cascade face box
    where OpenCV ships one (OpenCV 4; version 5 has none), else a static
    talking-head box (centred, upper part of the frame); the box becomes
    three anchors (brows a third down the box, nose at 55 %)."""

    def __init__(self):
        self.cascade = None
        if hasattr(cv2, "CascadeClassifier") and hasattr(cv2, "data"):
            try:
                self.cascade = cv2.CascadeClassifier(
                    cv2.data.haarcascades + "haarcascade_frontalface_default.xml")
            except Exception:  # noqa: BLE001 — no cascade: the static box
                self.cascade = None
        self.prev: Optional[np.ndarray] = None

    def _detect_box(self, image_rgb: np.ndarray):
        h, w = image_rgb.shape[:2]
        if self.cascade is not None:
            gray = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2GRAY)
            faces = self.cascade.detectMultiScale(gray, 1.1, 4, minSize=(40, 40))
            if len(faces):
                return max(faces, key=lambda f: f[2] * f[3])
        fw = int(w * 0.45)
        fh = int(fw * 1.2)
        return (w // 2 - fw // 2, int(h * 0.18), fw, fh)

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        x, y, fw, fh = self._detect_box(image_rgb)
        anchors = np.array([[x + 0.30 * fw, y + 0.33 * fh],
                            [x + 0.70 * fw, y + 0.33 * fh],
                            [x + 0.50 * fw, y + 0.55 * fh]])
        self.prev = anchors
        return anchors
