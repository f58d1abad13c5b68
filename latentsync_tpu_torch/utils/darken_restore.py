"""Face brightness correction (ref:latentsync/utils/darken_restore.py).

The port's own copy of ``latentsync_tpu/utils/darken_restore.py``, host
code on OpenCV. The reference brightens dark-lit faces after synthesis
inside a feathered convex-hull mask of mediapipe landmarks, scaling the HSV
value channel (ref:darken_restore.py:8-99), with an inverse factor
estimator (:379). The mask here comes from any landmark source (the FAN)
or the face-box heuristic, and the correction runs on in-memory frames.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def face_mask_from_landmarks(shape_hw, landmarks: np.ndarray, feather: int = 31) -> np.ndarray:
    """Feathered convex-hull mask in [0, 1] (ref:darken_restore.py:8-60)."""
    mask = np.zeros(shape_hw, np.uint8)
    hull = cv2.convexHull(landmarks.astype(np.int32))
    cv2.fillConvexPoly(mask, hull, 255)
    mask = cv2.GaussianBlur(mask, (feather, feather), 0)
    return mask.astype(np.float32) / 255.0


def face_mask_from_box(shape_hw, box, feather: int = 31) -> np.ndarray:
    mask = np.zeros(shape_hw, np.uint8)
    x, y, w, h = [int(v) for v in box]
    cv2.ellipse(mask, (x + w // 2, y + h // 2), (w // 2, h // 2), 0, 0, 360, 255, -1)
    mask = cv2.GaussianBlur(mask, (feather, feather), 0)
    return mask.astype(np.float32) / 255.0


def enhance_face_brightness(frames: np.ndarray, brightness_factor: float = 1.0,
                            landmark_detector=None) -> np.ndarray:
    """Scale the V channel inside the face region (ref:darken_restore.py:
    99-260). frames (F, H, W, 3) uint8 RGB; returns a corrected copy. A
    frame whose landmarks fail keeps the last mask, and the first such
    frame falls back to the Haar box, as in the JAX module."""
    if abs(brightness_factor - 1.0) < 1e-3:
        return frames
    out = np.empty_like(frames)
    mask = None
    for i, frame in enumerate(frames):
        if landmark_detector is not None:
            try:
                lm = landmark_detector(frame)
                mask = face_mask_from_landmarks(frame.shape[:2], np.asarray(lm))
            except Exception:  # noqa: BLE001 — keep the last mask
                pass
        if mask is None:
            from .face import HaarAnchorDetector

            mask = face_mask_from_box(frame.shape[:2], HaarAnchorDetector()._detect_box(frame))
        hsv = cv2.cvtColor(frame, cv2.COLOR_RGB2HSV).astype(np.float32)
        boosted = np.clip(hsv[:, :, 2] * brightness_factor, 0, 255)
        hsv[:, :, 2] = hsv[:, :, 2] * (1 - mask) + boosted * mask
        out[i] = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
    return out


def calculate_inverse_factor(factor: float) -> float:
    """Inverse brightness factor (ref:darken_restore.py:379)."""
    return 1.0 / max(factor, 1e-6)
