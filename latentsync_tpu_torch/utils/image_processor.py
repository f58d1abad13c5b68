"""Face-crop preparation for the fix_mask serving path.

The subset of ``latentsync_tpu/utils/image_processor.py`` the serving
path runs: the fixed mouth mask (decoded with zlib and numpy, no
OpenCV), [-1, 1] normalisation, the compact KEEP mask, and the batch
resize. Face detection and the landmark mask modes are not ported yet.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from .native import restore_lib

_DEFAULT_MASK_PATH = os.path.join(os.path.dirname(__file__), "assets", "mask.png")
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type → samples per pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (8-bit samples)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential within the row
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """8-bit, non-interlaced PNG → (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are supported")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


def resize_u8(images: np.ndarray, hw) -> np.ndarray:
    """(N, H, W, 3) uint8 bilinear resize through the native restore library."""
    return restore_lib().resize_frames_native(images, hw)


def load_fixed_mask(resolution: int, mask_image_path: Optional[str] = None) -> np.ndarray:
    """The fixed mouth mask as (H, W, 3) float32 in [0, 1] (1 = keep)."""
    img = read_png(mask_image_path or _DEFAULT_MASK_PATH)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    img = np.ascontiguousarray(img[..., :3])
    if img.shape[:2] != (resolution, resolution):
        img = resize_u8(img[None], (resolution, resolution))[0]
    return img.astype(np.float32) / 255.0


class ImageProcessor:
    """fix_mask face preparation: uint8 RGB (F, H, W, 3) in, float32 out."""

    def __init__(self, resolution: int = 256, mask: str = "fix_mask",
                 mask_image: Optional[np.ndarray] = None):
        if mask != "fix_mask":
            raise NotImplementedError(f"mask mode {mask!r} is not ported yet (fix_mask only)")
        self.resolution = resolution
        self.mask = mask
        self.mask_image = mask_image if mask_image is not None else load_fixed_mask(resolution)

    def normalize(self, images: np.ndarray) -> np.ndarray:
        """uint8 → float32 in [-1, 1]."""
        return images.astype(np.float32) / 255.0 * 2.0 - 1.0

    def resize_batch(self, images: np.ndarray) -> np.ndarray:
        if images.shape[1:3] == (self.resolution, self.resolution):
            return images
        return resize_u8(images, (self.resolution, self.resolution))

    def keep_mask(self, faces: np.ndarray) -> np.ndarray:
        """(1, H, W, 3) KEEP mask shared by every frame of the clip."""
        return self.mask_image[None]
