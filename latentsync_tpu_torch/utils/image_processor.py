"""Face crops, masks and the default landmark source.

Counterpart of ``latentsync_tpu/utils/image_processor.py``: the fixed
mouth mask and the resizes as OpenCV gives them (LANCZOS4 for the mask;
INTER_AREA when a face shrinks, INTER_LINEAR when it grows), [-1, 1]
normalisation, the KEEP masks of every mode (``fix_mask`` and ``half``
per clip; ``mouth``, ``face`` and ``eye`` per frame, from 68-point or
478-point mesh landmarks), the affine face alignment of a whole clip,
and the default landmark detector: the 2D-FAN on the pipeline's device
(a checkpoint at ``$LATENTSYNC_FAN_CKPT``, else the packaged fallback FAN
behind the Haar box stage, unless ``$LATENTSYNC_NO_FALLBACK_FAN`` is set),
with an S3FD box stage when ``$LATENTSYNC_S3FD_CKPT`` names a file.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import cv2
import numpy as np

from .face import AlignRestore, HaarAnchorDetector, LandmarkSmoother, landmarks68_to_anchor3

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
_DEFAULT_MASK_PATH = os.path.join(_ASSETS, "mask.png")
FALLBACK_FAN_PATH = os.path.join(_ASSETS, "landmark_fallback.npz")

# mediapipe face-mesh indices: the 68-point subset of the 478 mesh points,
# and the rings around the mouth and the lower face of the mouth / face modes
LANDMARK_POINTS_68 = [
    162, 234, 93, 58, 172, 136, 149, 148, 152, 377, 378, 365, 397, 288,
    323, 454, 389, 71, 63, 105, 66, 107, 336, 296, 334, 293, 301, 168,
    197, 5, 4, 75, 97, 2, 326, 305, 33, 160, 158, 133, 153, 144, 362,
    385, 387, 263, 373, 380, 61, 39, 37, 0, 267, 269, 291, 405, 314, 17,
    84, 181, 78, 82, 13, 312, 308, 317, 14, 87,
]
MOUTH_SURROUND_LANDMARKS = [
    164, 165, 167, 92, 186, 57, 43, 106, 182, 83, 18, 313, 406, 335,
    273, 287, 410, 322, 391, 393,
]
FACE_SURROUND_LANDMARKS = [
    152, 377, 400, 378, 379, 365, 397, 288, 435, 433, 411, 425, 423,
    327, 326, 94, 97, 98, 203, 205, 187, 213, 215, 58, 172, 136, 150,
    149, 176, 148,
]
# the nose-bridge point whose row splits the face in the eye mode
EYE_SPLIT_LANDMARK = 195
# 68-point equivalents: outer-lip ring, lower-face ring (jawline closed
# under the nose), and the mid-nose-bridge split row
MOUTH_RING_68 = list(range(48, 60))
FACE_RING_68 = list(range(2, 15)) + [35, 34, 33, 32, 31]
EYE_SPLIT_68 = 28


def landmark_mask_from_68(mask_mode: str, lm68: np.ndarray, resolution: int,
                          mouth_dilate: float = 1.3) -> np.ndarray:
    """KEEP mask of the mouth / face / eye modes from 68-point landmarks:
    the outer-lip polygon dilated about its centroid, the jawline closed
    under the nose, or everything below the nose-bridge row."""
    lm68 = np.asarray(lm68, np.float64)
    mask = np.ones((resolution, resolution), np.float32)
    if mask_mode == "mouth":
        pts = lm68[MOUTH_RING_68, :2]
        c = pts.mean(0)
        pts = c + (pts - c) * mouth_dilate
        cv2.fillConvexPoly(mask, cv2.convexHull(pts.astype(np.int32)), 0.0)
    elif mask_mode == "face":
        cv2.fillConvexPoly(mask, cv2.convexHull(lm68[FACE_RING_68, :2].astype(np.int32)), 0.0)
    elif mask_mode == "eye":
        mask[max(int(lm68[EYE_SPLIT_68][1]), 0):, :] = 0.0
    else:
        raise ValueError(f"unknown mask mode {mask_mode!r}")
    return mask


def mediapipe_lm478_to_lm68(lm478: np.ndarray) -> np.ndarray:
    """(478, 2+) mesh landmarks → (68, 2) face-alignment landmarks."""
    return np.asarray(lm478)[LANDMARK_POINTS_68, :2].astype(np.float64)


def load_fixed_mask(resolution: int, mask_image_path: Optional[str] = None) -> np.ndarray:
    """The fixed mouth mask as (H, W, 3) float32 in [0, 1] (1 = keep),
    resized with LANCZOS4; a generated lower-face mask where the file is
    missing."""
    path = mask_image_path or _DEFAULT_MASK_PATH
    if os.path.isfile(path):
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (resolution, resolution), interpolation=cv2.INTER_LANCZOS4)
        return img.astype(np.float32) / 255.0
    return _generated_mouth_mask(resolution)


def _generated_mouth_mask(resolution: int) -> np.ndarray:
    """A binary lower-face mask shaped like the shipped mask.png (dark
    rounded region over rows 0.37-0.95 of the crop)."""
    m = np.ones((resolution, resolution), np.uint8) * 255
    cv2.ellipse(m, (resolution // 2, int(resolution * 0.66)),
                (int(resolution * 0.47), int(resolution * 0.29)), 0, 0, 360, 0, -1)
    m = (m > 127).astype(np.float32)
    return np.repeat(m[:, :, None], 3, axis=2)


_warned_fallback = False
_detector_cache: dict = {}


def default_landmark_detector(device=None):
    """The default landmark source, memoized per environment (the three
    variables below) and device: one detector serves every clip."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    key = tuple(os.environ.get(k, "") for k in (
        "LATENTSYNC_FAN_CKPT", "LATENTSYNC_S3FD_CKPT", "LATENTSYNC_NO_FALLBACK_FAN"))
    key += (str(dev),)
    if key not in _detector_cache:
        _detector_cache[key] = _build_default_landmark_detector(dev)
    return _detector_cache[key]


def _build_default_landmark_detector(device):
    """A FAN (with an S3FD box stage where its file exists) from
    ``$LATENTSYNC_FAN_CKPT`` (a ``.pth`` / ``.pt`` state dict, or an
    ``.npz`` of the port's names or of the JAX package's tree), else the
    packaged fallback FAN behind the Haar box stage, else (with
    ``$LATENTSYNC_NO_FALLBACK_FAN``) the Haar anchor heuristic, warned."""
    global _warned_fallback
    from ..models.face_detection import FANLandmarkDetector, HaarBoxDetector, S3FDDetector
    from .convert import (fan_state_dict_from_flax, load_state_dict_file,
                          s3fd_state_dict_from_flax)

    fan_path = os.environ.get("LATENTSYNC_FAN_CKPT", "checkpoints/2dfan4.npz")
    if os.path.isfile(fan_path):
        face_det = None
        s3fd_path = os.environ.get("LATENTSYNC_S3FD_CKPT", "checkpoints/s3fd.npz")
        if os.path.isfile(s3fd_path):
            face_det = S3FDDetector(load_state_dict_file(s3fd_path, s3fd_state_dict_from_flax),
                                    device=device)
        return FANLandmarkDetector(load_state_dict_file(fan_path, fan_state_dict_from_flax),
                                   face_detector=face_det, device=device)
    if os.path.isfile(FALLBACK_FAN_PATH) and not os.environ.get("LATENTSYNC_NO_FALLBACK_FAN"):
        return FANLandmarkDetector(load_state_dict_file(FALLBACK_FAN_PATH),
                                   face_detector=HaarBoxDetector(), device=device)
    if not _warned_fallback:
        _warned_fallback = True
        warnings.warn("no FAN landmark checkpoint found (set LATENTSYNC_FAN_CKPT); falling back "
                      "to the Haar-box anchor heuristic: alignment is box-level only",
                      stacklevel=2)
    return HaarAnchorDetector()


class ImageProcessor:
    """Face alignment and mask preparation: uint8 RGB (F, H, W, 3) in,
    float32 in [-1, 1] out, channels last. `device`: where the default
    landmark detector runs (the card unless the caller asks for another)."""

    def __init__(self, resolution: int = 256, mask: str = "fix_mask",
                 mask_image: Optional[np.ndarray] = None, landmark_detector=None,
                 face_mesh=None, device=None):
        """`face_mesh`: callable image → (478, 2) mesh landmarks in pixels,
        for the mouth / face / eye modes where a mesh source is wanted."""
        self.resolution = resolution
        self.mask = mask
        self.mask_image = None
        if mask == "fix_mask":
            self.mask_image = mask_image if mask_image is not None else load_fixed_mask(
                resolution)
        self.smoother = LandmarkSmoother()
        self.restorer = AlignRestore()
        self.landmark_detector = landmark_detector
        self.face_mesh = face_mesh
        self.device = device

    def _detector(self):
        if self.landmark_detector is None:
            self.landmark_detector = default_landmark_detector(self.device)
        return self.landmark_detector

    # -- geometry -----------------------------------------------------------

    def _anchor3(self, lm: np.ndarray) -> np.ndarray:
        lm = np.asarray(lm)
        if lm.shape[0] == 478:
            lm = mediapipe_lm478_to_lm68(lm)
        return landmarks68_to_anchor3(self.smoother(lm)) if lm.shape[0] == 68 else lm

    def detect_anchor3(self, image_rgb: np.ndarray) -> np.ndarray:
        return self._anchor3(self._detector()(image_rgb))

    def affine_transform(self, image_rgb: np.ndarray):
        """Frame → (face crop at the resolution, box, 2×3 matrix)."""
        return self._warp_from_anchor3(image_rgb, self.detect_anchor3(image_rgb))

    def _warp_from_anchor3(self, image_rgb: np.ndarray, anchor3: np.ndarray):
        face, matrix = self.restorer.align_warp_face(image_rgb, anchor3)
        box = [0, 0, face.shape[1], face.shape[0]]
        face = cv2.resize(face, (self.resolution, self.resolution),
                          interpolation=cv2.INTER_LANCZOS4)
        return face, box, matrix

    def affine_transform_batch(self, frames):
        """A whole clip → (faces (N, r, r, 3), boxes, matrices). A detector
        with ``detect_batch`` (the FAN) takes every frame in one pass;
        smoothing and warps stay per frame, in order."""
        det = self._detector()
        faces, boxes, matrices = [], [], []
        if hasattr(det, "detect_batch"):
            for frame, lm in zip(frames, det.detect_batch(frames)):
                face, box, matrix = self._warp_from_anchor3(frame, self._anchor3(lm))
                faces.append(face)
                boxes.append(box)
                matrices.append(matrix)
        else:
            for frame in frames:
                face, box, matrix = self.affine_transform(frame)
                faces.append(face)
                boxes.append(box)
                matrices.append(matrix)
        return np.stack(faces), boxes, matrices

    # -- normalisation and masks -------------------------------------------

    def normalize(self, images: np.ndarray) -> np.ndarray:
        """uint8 → float32 in [-1, 1]."""
        return images.astype(np.float32) / 255.0 * 2.0 - 1.0

    def resize_batch(self, images: np.ndarray) -> np.ndarray:
        if images.shape[1:3] == (self.resolution, self.resolution):
            return images
        r = self.resolution
        return np.stack([cv2.resize(im, (r, r), interpolation=cv2.INTER_AREA
                                    if im.shape[0] > r else cv2.INTER_LINEAR)
                         for im in images])

    def _landmark_mask(self, face: np.ndarray, lm: Optional[np.ndarray]) -> np.ndarray:
        """Per-frame KEEP mask of the mouth / face / eye modes. Landmarks:
        `lm` ((478, 2) mesh or (68, 2) points), else the bound `face_mesh`,
        else the landmark detector run on the crop."""
        if lm is None:
            if self.face_mesh is not None:
                lm = np.asarray(self.face_mesh(face))
            else:
                lm = np.asarray(self._detector()(face))
                if lm.shape[0] < 68:
                    raise ValueError(
                        f"mask mode {self.mask!r} needs dense landmarks; the configured "
                        "detector returned only box anchors: set LATENTSYNC_FAN_CKPT or pass "
                        "landmarks478 / face_mesh")
        lm = np.asarray(lm)
        if lm.shape[0] == 68:
            return landmark_mask_from_68(self.mask, lm, self.resolution)
        mask = np.ones((self.resolution, self.resolution), np.float32)
        if self.mask in ("mouth", "face"):
            ring = MOUTH_SURROUND_LANDMARKS if self.mask == "mouth" else FACE_SURROUND_LANDMARKS
            cv2.fillPoly(mask, pts=[lm[ring, :2].astype(np.int32)], color=0.0)
        elif self.mask == "eye":
            mask[max(int(lm[EYE_SPLIT_LANDMARK][1]), 0):, :] = 0.0
        else:
            raise ValueError(f"unknown mask mode {self.mask!r}")
        return mask

    def keep_mask(self, faces: np.ndarray, landmarks478: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """KEEP mask (1 = keep, 0 = regenerate): (1, H, W, 3) for the per-clip
        fix_mask and half modes, (F, H, W, 1) for the per-frame modes."""
        if self.mask == "fix_mask":
            return self.mask_image[None]
        if self.mask == "half":
            keep = np.ones((1, self.resolution, self.resolution, 3), np.float32)
            keep[:, self.resolution // 2:] = 0
            return keep
        faces = self.resize_batch(faces)
        return np.stack([
            self._landmark_mask(faces[i], None if landmarks478 is None else landmarks478[i])
            for i in range(len(faces))])[..., None]

    def prepare_masks_and_masked_images(self, faces: np.ndarray,
                                        landmarks478: Optional[np.ndarray] = None):
        """(F, H, W, 3) uint8 → (pixel_values, masked_pixel_values, masks)
        float32, KEEP polarity: masked = pixels · mask."""
        faces = self.resize_batch(faces)
        pixel_values = self.normalize(faces)
        keep = self.keep_mask(faces, landmarks478)
        masked = pixel_values * keep
        masks = np.broadcast_to(keep[..., :1], pixel_values.shape[:3] + (1,))
        return pixel_values, masked, np.ascontiguousarray(masks)

    def denormalize(self, images: np.ndarray) -> np.ndarray:
        """float [-1, 1] → uint8."""
        return np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
