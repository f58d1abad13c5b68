"""Avatar artifacts: the affine bundle an onboarding writes, and avatar
resolution (id → pre-uploaded video + bundle).

Counterpart of ``latentsync_tpu/serving/artifacts.py`` (the upstream
``_rotated``/``_darken`` variant naming; the bundle is an ``.npz`` of
``faces``, ``boxes`` and ``affine_matrices``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


def generate_affine_bundle(processor, video_path: str, bundle_path: str, fps: int = 25) -> str:
    """Align every frame of a video (read at `fps`) with `processor`
    (``ImageProcessor.affine_transform_batch``: the landmark model takes the
    whole clip) and write the bundle. Returns its path."""
    from ..utils.media import read_video

    frames = read_video(video_path, change_fps=True, fps=fps)
    faces, boxes, matrices = processor.affine_transform_batch(frames)
    os.makedirs(os.path.dirname(bundle_path) or ".", exist_ok=True)
    np.savez_compressed(bundle_path, faces=np.asarray(faces), boxes=np.asarray(boxes),
                        affine_matrices=np.stack(matrices))
    return bundle_path


def load_affine_bundle(bundle_path: str):
    with np.load(bundle_path, allow_pickle=False) as data:
        return data["faces"], list(data["boxes"]), list(data["affine_matrices"])


@dataclass
class Avatar:
    video_path: str
    bundle_path: Optional[str]


class AvatarStore:
    def __init__(self, root: str):
        self.root = root

    def resolve(self, avatar_id: str, rotated: bool = False, darken: bool = False) -> Avatar:
        suffix = ("_rotated" if rotated else "") + ("_darken" if darken else "")
        base = os.path.join(self.root, avatar_id + suffix)
        video = base + ".mp4"
        if not os.path.isfile(video):
            raise FileNotFoundError(f"avatar video not found: {video}")
        bundle = base + ".npz"
        return Avatar(video_path=video, bundle_path=bundle if os.path.isfile(bundle) else None)
