"""Face tracks for SyncNet scoring.

Counterpart of ``latentsync_tpu/eval/syncnet_detect.py``
(ref:eval/syncnet_detect.py:25-251): decode the frames, detect a face in
each, split shots, stitch IoU tracks, smooth the boxes and cut 224² face
clips for the scorer. Host code (numpy, SciPy, OpenCV) around a per-frame
box detector, the Haar-anchor box by default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..models.face_detection import iou_tracking
from ..preprocess.pipeline import detect_shots
from ..utils.media import read_video, write_video


@dataclass
class FaceTrack:
    frames: List[int]
    boxes: np.ndarray  # (n, 4)


class HaarBoxAdapter:
    """The Haar-anchor detector's face box as one (x1, y1, x2, y2, 1) row."""

    def __init__(self):
        from ..utils.face import HaarAnchorDetector

        self.det = HaarAnchorDetector()

    def detect(self, img: np.ndarray) -> np.ndarray:
        x, y, w, h = self.det._detect_box(img)
        return np.array([[x, y, x + w, y + h, 1.0]], np.float32)


class SyncNetDetector:
    """ref:syncnet_detect.py SyncNetDetector.__call__. `face_detector`: an
    object whose ``detect(frame)`` gives (n, 4 or 5) box rows."""

    def __init__(self, face_detector=None, min_track: int = 50, crop_scale: float = 0.4,
                 min_face_size: float = 100.0):
        self.detector = face_detector if face_detector is not None else HaarBoxAdapter()
        self.min_track = min_track
        self.crop_scale = crop_scale
        self.min_face_size = min_face_size

    def extract_tracks(self, frames: np.ndarray) -> List[FaceTrack]:
        """Shot split, then gap-tolerant IoU stitching (ref:eval/syncnet_detect.py:76-83,
        108-148). Shots shorter than `min_track` are skipped as in the
        reference, except in a clip shorter than `min_track` in all, which is
        still tracked (so that short clips stay scoreable)."""
        cuts = [0] + detect_shots(frames) + [len(frames)]
        short_clip = len(frames) <= self.min_track
        tracks: List[FaceTrack] = []
        for s in range(len(cuts) - 1):
            shot = frames[cuts[s]:cuts[s + 1]]
            if len(shot) < self.min_track and not short_clip:
                continue
            dets = [self.detector.detect(fr) for fr in shot]
            for tr in iou_tracking(dets, min_track=min(self.min_track, max(len(shot) - 1, 1)),
                                   num_failed_det=25,
                                   min_face_size=0 if short_clip else self.min_face_size):
                tracks.append(FaceTrack(frames=[f + cuts[s] for f in tr["frames"]],
                                        boxes=np.asarray(tr["boxes"], np.float32)))
        return tracks

    def crop_track(self, frames: np.ndarray, track: FaceTrack, size: int = 224) -> np.ndarray:
        """The reference's crop geometry (ref:eval/syncnet_detect.py:169-206):
        box size and centre median-filtered (kernel 13, or the largest odd
        one the track allows), padding of constant 110, and the asymmetric
        crop [cy − s, cy + s(1 + 2c)] × [cx − s(1 + c), cx + s(1 + c)] that
        takes in the chin."""
        import cv2
        from scipy.signal import medfilt

        b = track.boxes
        s_arr = np.maximum(b[:, 3] - b[:, 1], b[:, 2] - b[:, 0]) / 2.0
        x_arr = (b[:, 0] + b[:, 2]) / 2.0
        y_arr = (b[:, 1] + b[:, 3]) / 2.0
        k = min(13, len(b) - (1 - len(b) % 2))
        if k >= 3:
            s_arr = medfilt(s_arr, kernel_size=k)
            x_arr = medfilt(x_arr, kernel_size=k)
            y_arr = medfilt(y_arr, kernel_size=k)
        cs = self.crop_scale
        crops = []
        for i, fi in enumerate(track.frames):
            bs = s_arr[i]
            bsi = int(bs * (1 + 2 * cs))
            padded = np.pad(frames[fi], ((bsi, bsi), (bsi, bsi), (0, 0)), "constant",
                            constant_values=110)
            my, mx = y_arr[i] + bsi, x_arr[i] + bsi
            face = padded[int(my - bs):int(my + bs * (1 + 2 * cs)),
                          int(mx - bs * (1 + cs)):int(mx + bs * (1 + cs))]
            crops.append(cv2.resize(face, (size, size)))
        return np.stack(crops)

    def __call__(self, video_path: str, out_dir: Optional[str] = None):
        """[(crop clip, track)] of the video at 25 fps; with `out_dir`, each
        clip also written there as ``track_%04d.mp4`` (ref: the pycrop clips)."""
        frames = read_video(video_path, change_fps=True, fps=25)
        results = []
        for i, track in enumerate(self.extract_tracks(frames)):
            crops = self.crop_track(frames, track)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                write_video(os.path.join(out_dir, f"track_{i:04d}.mp4"), crops, fps=25)
            results.append((crops, track))
        return results
