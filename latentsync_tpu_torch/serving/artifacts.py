"""Avatar resolution: id → pre-uploaded video + precomputed affine bundle.

Counterpart of ``latentsync_tpu/serving/artifacts.py`` (the upstream
``_rotated``/``_darken`` variant naming; the bundle is an ``.npz`` of
``faces``, ``boxes`` and ``affine_matrices``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np


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
