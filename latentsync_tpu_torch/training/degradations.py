"""Blind-degradation training data for face restoration.

Re-derivation of the FFHQ blind dataset pipeline (ref:basicsr/data/
ffhq_blind_dataset.py + basicsr/data/degradations.py): random gaussian
blur → random downscale → gaussian noise → JPEG compression → upscale
back, producing (LQ, GT) pairs. Includes the matlab-style bicubic
imresize the reference relies on (ref:basicsr/utils/matlab_functions.py).

Counterpart of ``latentsync_tpu/training/degradations.py``: host code in
numpy and OpenCV, as there, so the same seed gives the same pairs in both
packages; the samples are (H, W, 3) f32 in [-1, 1], the trainers move them
to the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def cubic(x):
    """Matlab bicubic kernel (a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def imresize_matlab(img: np.ndarray, scale: float) -> np.ndarray:
    """Matlab-compatible antialiased bicubic resize (separable weights,
    ref:basicsr/utils/matlab_functions.py imresize)."""

    def weights(in_len, out_len, scale):
        kernel_width = 4.0
        if scale < 1:
            kernel_width /= scale
        x = np.arange(1, out_len + 1, dtype=np.float64)
        u = x / scale + 0.5 * (1 - 1 / scale)
        left = np.floor(u - kernel_width / 2)
        p = int(np.ceil(kernel_width)) + 2
        idx = left[:, None] + np.arange(p)[None, :] - 1
        dist = u[:, None] - idx - 1
        if scale < 1:
            w = scale * cubic(dist * scale)
        else:
            w = cubic(dist)
        w = w / w.sum(axis=1, keepdims=True)
        idx = np.clip(idx, 0, in_len - 1).astype(int)
        return w, idx

    out = img.astype(np.float64)
    for axis in (0, 1):
        in_len = out.shape[axis]
        out_len = int(np.ceil(in_len * scale))
        w, idx = weights(in_len, out_len, scale)
        moved = np.moveaxis(out, axis, 0)
        gathered = moved[idx]  # (out_len, p, ...)
        res = np.einsum("op,op...->o...", w, gathered)
        out = np.moveaxis(res, 0, axis)
    return out


def gaussian_kernel2d(size: int, sigma: float) -> np.ndarray:
    t = np.arange(size) - size // 2
    k = np.exp(-(t**2) / (2 * sigma**2))
    k2 = np.outer(k, k)
    return k2 / k2.sum()


@dataclass
class BlindDegradationConfig:
    """(ref:options/*.yml blur_kernel_size/kernel_list/noise/jpeg ranges)."""

    blur_kernel_size: int = 41
    blur_sigma: Tuple[float, float] = (0.1, 10.0)
    downsample_range: Tuple[float, float] = (0.8, 8.0)
    noise_range: Tuple[float, float] = (0.0, 20.0)
    jpeg_range: Tuple[int, int] = (60, 100)
    gt_size: int = 512


class BlindDegrader:
    """GT face image → (LQ, GT) pair."""

    def __init__(self, config: BlindDegradationConfig = BlindDegradationConfig(),
                 seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)

    def __call__(self, gt_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        import cv2

        cfg = self.cfg
        gt = cv2.resize(gt_rgb, (cfg.gt_size, cfg.gt_size))
        img = gt.astype(np.float32) / 255.0

        # blur
        sigma = self.rng.uniform(*cfg.blur_sigma)
        k = gaussian_kernel2d(cfg.blur_kernel_size, sigma).astype(np.float32)
        img = cv2.filter2D(img, -1, k)
        # downsample
        scale = self.rng.uniform(*cfg.downsample_range)
        small = cv2.resize(img, (int(cfg.gt_size / scale),) * 2,
                           interpolation=cv2.INTER_LINEAR)
        # noise
        nstd = self.rng.uniform(*cfg.noise_range) / 255.0
        if nstd > 0:
            small = small + self.rng.normal(0, nstd, small.shape).astype(np.float32)
        small = np.clip(small, 0, 1)
        # jpeg
        q = int(self.rng.uniform(*cfg.jpeg_range))
        ok, enc = cv2.imencode(".jpg", (small * 255).astype(np.uint8),
                               [cv2.IMWRITE_JPEG_QUALITY, q])
        small = cv2.imdecode(enc, cv2.IMREAD_COLOR).astype(np.float32) / 255.0
        # upscale back
        lq = cv2.resize(small, (cfg.gt_size, cfg.gt_size),
                        interpolation=cv2.INTER_LINEAR)
        return (lq * 255).astype(np.uint8), gt


class FFHQBlindSource:
    """Dataset source: face images → normalized (lq, gt) samples
    (ref:basicsr/data/ffhq_blind_dataset.py).

    `image_dir` is a directory of loose images, or a basicsr-convention
    `*.lmdb` environment (keys from meta_info.txt, PNG-encoded values —
    ref:basicsr/utils/file_client.py io_backend 'lmdb'), read through
    training/file_client.py's dependency-free LMDB reader."""

    def __init__(self, image_dir: str, config=BlindDegradationConfig(), seed: int = 0):
        import os

        self._client = None
        if image_dir.rstrip("/").endswith(".lmdb"):
            from .file_client import FileClient, read_lmdb_meta

            self._client = FileClient(
                "lmdb", db_paths=image_dir, client_keys="gt")
            self.paths = read_lmdb_meta(image_dir)
        else:
            self.paths = sorted(
                os.path.join(image_dir, f) for f in os.listdir(image_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))
            )
        self.degrader = BlindDegrader(config, seed)
        self.rng = np.random.default_rng(seed)
        self.seed = seed

    def _read(self, path: str) -> np.ndarray:
        import cv2

        if self._client is not None:
            buf = np.frombuffer(self._client.get(path, "gt"), np.uint8)
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        else:
            img = cv2.imread(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def sample(self):
        path = self.paths[int(self.rng.integers(0, len(self.paths)))]
        img = self._read(path)
        lq, gt = self.degrader(img)
        norm = lambda x: x.astype(np.float32) / 127.5 - 1.0
        return {"lq": norm(lq), "gt": norm(gt)}
