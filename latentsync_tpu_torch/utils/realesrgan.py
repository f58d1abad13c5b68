"""Tiled RealESRGAN upsampler: RRDBNet over overlapping tiles, so frames of
any size fit the device.

Counterpart of ``latentsync_tpu/utils/realesrgan.py`` (basicsr's
``realesrgan_utils.py``; the CodeFormer CLI's background / face
upsampler). Each tile, with `tile_pad` pixels of context on each side
where the frame has them, is placed at the top left of a fixed
(tile + 2 tile_pad)² zero canvas, as the reference does (so the zeros
beyond a frame's edge reach the border pixels of its outer tiles); the net
runs on the canvas and the tile's core is cut from the output.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class RealESRGANUpsampler:
    """``enhance(img_rgb)`` → the frame `scale` times larger, uint8 RGB. The
    net runs on `device` (the card unless asked otherwise) in `dtype` (bf16
    by default, as the reference's); without a state dict its weights are
    seeded random (``init_random_``)."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None, scale: int = 2,
                 tile: int = 256, tile_pad: int = 16, dtype=torch.bfloat16, device=None):
        from ..models.rrdbnet import RRDBNet
        from .convert import init_random_

        self.scale, self.tile, self.tile_pad = scale, tile, tile_pad
        self.device = torch.device("cuda" if device is None else device)
        self.model = RRDBNet(scale=scale)
        if state_dict is None:
            init_random_(self.model, 0)
        else:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device, dtype).eval()

    @torch.inference_mode()
    def enhance(self, img_rgb: np.ndarray) -> np.ndarray:
        h, w = img_rgb.shape[:2]
        s, t, pad = self.scale, self.tile, self.tile_pad
        out = np.zeros((h * s, w * s, 3), np.float32)
        x = img_rgb.astype(np.float32) / 255.0
        for y0 in range(0, h, t):
            for x0 in range(0, w, t):
                ya, yb = max(y0 - pad, 0), min(y0 + t + pad, h)
                xa, xb = max(x0 - pad, 0), min(x0 + t + pad, w)
                tile_in = x[ya:yb, xa:xb]
                th, tw = tile_in.shape[:2]
                canvas = np.zeros((t + 2 * pad, t + 2 * pad, 3), np.float32)
                canvas[:th, :tw] = tile_in
                net_in = torch.from_numpy(canvas).to(self.device).permute(2, 0, 1)[None]
                tile_out = self.model(net_in)[0].permute(1, 2, 0).float().cpu().numpy()
                tile_out = tile_out[: th * s, : tw * s]
                oy, ox = (y0 - ya) * s, (x0 - xa) * s
                core = tile_out[oy: oy + min(t, h - y0) * s, ox: ox + min(t, w - x0) * s]
                out[y0 * s: y0 * s + core.shape[0], x0 * s: x0 * s + core.shape[1]] = core
        return np.clip(out * 255, 0, 255).astype(np.uint8)
