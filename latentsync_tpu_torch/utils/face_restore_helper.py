"""FaceRestoreHelper: detect → 5-landmark align → restore → paste back.

The port's copy of ``latentsync_tpu/utils/face_restore_helper.py`` (host
OpenCV code, the same bytes out for the same inputs; the port imports
nothing of the JAX package): read frame → face box + 5 landmarks →
similarity warp to the FFHQ 512 template → (restoration model runs) →
inverse warp with a soft (optionally parsing-guided) mask composite. The
landmark source is any callable (a detector's ``detect``, rows of
(x1, y1, x2, y2, conf, 5 · (lx, ly)); five points; or 68), by default the
port's ``utils/face.py`` ``HaarAnchorDetector`` box with fixed five points.
The 512 template below is the standard FFHQ 5-point layout the CodeFormer
weights expect.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

# FFHQ-aligned 5-point template for 512² crops (eyes, nose, mouth corners)
FFHQ_512_TEMPLATE = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.1936],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    np.float32,
)


def five_from_68(lm68: np.ndarray) -> np.ndarray:
    """68 landmarks → 5 points (eye centers, nose tip, mouth corners)."""
    return np.stack(
        [
            lm68[36:42].mean(0),
            lm68[42:48].mean(0),
            lm68[30],
            lm68[48],
            lm68[54],
        ]
    )


@dataclass
class RestoredFace:
    crop: np.ndarray
    affine: np.ndarray
    box: Tuple[int, int, int, int]


class FaceRestoreHelper:
    """(ref:face_restoration_helper.py:54). upscale_factor scales the
    output frame; face_size is the model's input (512 for CodeFormer)."""

    def __init__(self, upscale_factor: float = 1.0, face_size: int = 512,
                 landmark_detector=None, parser=None):
        self.upscale = upscale_factor
        self.face_size = face_size
        self.template = FFHQ_512_TEMPLATE * (face_size / 512.0)
        self.landmark_detector = landmark_detector
        self.parser = parser  # optional parsing net for mask-guided blend

    def align_faces(self, image_rgb: np.ndarray) -> List[RestoredFace]:
        """Detect + warp every face to face_size² crops
        (ref:face_restoration_helper.py:196-350)."""
        if self.landmark_detector is None:
            from .face import HaarAnchorDetector

            det = HaarAnchorDetector()
            x, y, w, h = det._detect_box(image_rgb)
            lm5 = np.array(
                [
                    [x + 0.3 * w, y + 0.4 * h],
                    [x + 0.7 * w, y + 0.4 * h],
                    [x + 0.5 * w, y + 0.6 * h],
                    [x + 0.35 * w, y + 0.78 * h],
                    [x + 0.65 * w, y + 0.78 * h],
                ],
                np.float32,
            )
            lms = [lm5]
        else:
            lm = self.landmark_detector(image_rgb)
            lm = np.asarray(lm) if lm is not None else None
            if lm is None or lm.size == 0:
                lms = []
            elif lm.ndim == 2 and lm.shape[1] == 15:
                # detector rows (x1,y1,x2,y2,conf, 5·(lx,ly)) — RetinaFace /
                # YOLOv5-face style, possibly multiple faces
                # (ref:face_restoration_helper.py:196-240 get_face_landmarks_5)
                lms = [row[5:15].reshape(5, 2).astype(np.float32) for row in lm]
            elif lm.ndim == 2 and lm.shape == (5, 2):
                lms = [lm.astype(np.float32)]
            else:
                lms = [five_from_68(lm)]

        faces = []
        for lm5 in lms:
            m, _ = cv2.estimateAffinePartial2D(
                lm5.astype(np.float32), self.template, method=cv2.LMEDS
            )
            crop = cv2.warpAffine(
                image_rgb, m, (self.face_size, self.face_size),
                borderMode=cv2.BORDER_CONSTANT, borderValue=(135, 133, 132),
            )
            faces.append(RestoredFace(crop=crop, affine=m,
                                      box=(0, 0, self.face_size, self.face_size)))
        return faces

    def paste_faces(self, image_rgb: np.ndarray,
                    restored: List[Tuple[RestoredFace, np.ndarray]]) -> np.ndarray:
        """Inverse-warp restored crops with soft/parsing masks
        (ref:face_restoration_helper.py:372-520)."""
        h, w = image_rgb.shape[:2]
        up_h, up_w = int(h * self.upscale), int(w * self.upscale)
        out = cv2.resize(image_rgb, (up_w, up_h),
                         interpolation=cv2.INTER_LANCZOS4).astype(np.float32)
        for face, restored_crop in restored:
            inv = cv2.invertAffineTransform(face.affine) * self.upscale
            warped = cv2.warpAffine(restored_crop, inv, (up_w, up_h))
            if self.parser is not None:
                mask = self.parser(restored_crop)  # (fs, fs) float in [0,1]
            else:
                mask = np.ones((self.face_size, self.face_size), np.float32)
            inv_mask = cv2.warpAffine(mask, inv, (up_w, up_h))
            inv_mask = cv2.erode(
                inv_mask, np.ones((int(2 * self.upscale), int(2 * self.upscale)), np.uint8)
            )
            edge = int(np.sqrt(inv_mask.sum())) // 20
            if edge > 0:
                inv_mask = cv2.erode(inv_mask, np.ones((edge, edge), np.uint8))
                inv_mask = cv2.GaussianBlur(inv_mask, (edge * 2 + 1, edge * 2 + 1), 0)
            out = inv_mask[:, :, None] * warped + (1 - inv_mask[:, :, None]) * out
        return np.clip(out, 0, 255).astype(np.uint8)
