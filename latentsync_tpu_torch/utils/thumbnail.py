"""Captioned GIF thumbnails under a size cap
(ref:latentsync/utils/thumbnail.py:64-312).

The port's own copy of ``latentsync_tpu/utils/thumbnail.py``, host code on
PIL: an animated GIF from frames sampled over the video, a caption strip,
then narrower frames (or fewer) until the file is under `max_bytes`.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np


def create_video_thumbnail_gif(video_path: str, gif_path: str, text: Optional[str] = None,
                               max_frames: int = 24, fps: int = 8, max_bytes: int = 2_000_000,
                               width: int = 320) -> str:
    from PIL import Image, ImageDraw

    from .media import read_video

    frames = read_video(video_path, change_fps=False)
    idx = np.linspace(0, len(frames) - 1, min(max_frames, len(frames))).astype(int)
    sampled = frames[idx]

    def build(width_px: int, n_frames: int) -> bytes:
        imgs = []
        stride = max(1, len(sampled) // n_frames)
        for frame in sampled[::stride][:n_frames]:
            im = Image.fromarray(frame)
            h = int(im.height * width_px / im.width)
            im = im.resize((width_px, h))
            if text:
                draw = ImageDraw.Draw(im)
                strip_h = max(18, h // 10)
                draw.rectangle([(0, h - strip_h), (width_px, h)], fill=(0, 0, 0))
                draw.text((6, h - strip_h + 3), text[:60], fill=(255, 255, 255))
            imgs.append(im.convert("P", palette=Image.ADAPTIVE))
        buf = io.BytesIO()
        imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0, optimize=True)
        return buf.getvalue()

    # the size-capped compression loop (ref:thumbnail.py:256)
    w, n = width, len(sampled)
    data = build(w, n)
    while len(data) > max_bytes and (w > 96 or n > 6):
        if w > 96:
            w = int(w * 0.8)
        else:
            n = max(6, n - 4)
        data = build(w, n)
    with open(gif_path, "wb") as f:
        f.write(data)
    return gif_path
