"""The paste-back, plain: mouth composite, the face resized to its box and
inverse-warped into the frame under an eroded, blurred mask.

LatentSync's ``ImageProcessor.restore_img`` / ``AlignRestore``: the
decoded face replaces the crop where the mouth mask is 0 (``decoded·(1−m)
+ original·m``, truncated to uint8); the face is resized bilinearly to its
box (half-pixel centres; a sample that falls past the last row or column
reads 0); the crop→frame warp is bilinear with taps outside the face
reading 0, with a ones channel beside the face as the paste mask; the
mask is eroded 2x2, then a soft copy eroded by (2·edge)² and blurred by a
zero-padded Gaussian of 2·edge + 1 taps (OpenCV's sigma for that size),
edge from the mean pasted area of the call's frames; the composite is
clamped to [0, 255] and truncated.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def composite(decoded_u8: torch.Tensor, pixel_u8: torch.Tensor, keep: torch.Tensor):
    """decoded (N, r, r, 3) uint8, the original face (N, r, r, 3) float in
    [0, 255], keep (N or 1, r, r, 1) float → (N, r, r, 3) uint8."""
    return (decoded_u8.float() * (1.0 - keep) + pixel_u8 * keep).to(torch.uint8)


def resize_bilinear_u8(src: torch.Tensor, out_hw) -> torch.Tensor:
    """(N, sh, sw, 3) uint8 → (N, dh, dw, 3) uint8."""
    n, sh, sw, c = src.shape
    dh, dw = out_hw
    dev = src.device
    sy = ((torch.arange(dh, device=dev, dtype=torch.float32) + 0.5) * (sh / dh) - 0.5
          ).clamp_min(0.0)
    sx = ((torch.arange(dw, device=dev, dtype=torch.float32) + 0.5) * (sw / dw) - 0.5
          ).clamp_min(0.0)
    vy, vx = sy <= sh - 1, sx <= sw - 1
    y0, x0 = sy.floor().long().clamp(max=sh - 1), sx.floor().long().clamp(max=sw - 1)
    y1, x1 = (y0 + 1).clamp(max=sh - 1), (x0 + 1).clamp(max=sw - 1)
    fy, fx = (sy - y0)[:, None, None], (sx - x0)[None, :, None]
    img = src.float()
    top = img[:, y0][:, :, x0] * (1 - fx) + img[:, y0][:, :, x1] * fx
    bot = img[:, y1][:, :, x0] * (1 - fx) + img[:, y1][:, :, x1] * fx
    out = top * (1 - fy) + bot * fy
    out = out * (vy[:, None, None] & vx[None, :, None])
    return out.clamp(0, 255).to(torch.uint8)


def _warp(images: torch.Tensor, matrices: torch.Tensor, out_hw) -> torch.Tensor:
    """Inverse-mapped bilinear warp, taps outside the image read 0."""
    b, h, w, c = images.shape
    oh, ow = out_hw
    dev = images.device
    a, t = matrices[:, :, :2].float(), matrices[:, :, 2].float()
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    ia = torch.stack([a[:, 1, 1], -a[:, 0, 1], -a[:, 1, 0], a[:, 0, 0]],
                     dim=-1).reshape(b, 2, 2) / det[:, None, None]
    it = -(ia[:, :, 1].double() * t[:, None, 1].double()
           + (ia[:, :, 0] * t[:, None, 0]).double()).float()
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    sx = ia[:, 0, 0, None] * xs + ia[:, 0, 1, None] * ys + it[:, 0, None]
    sy = ia[:, 1, 0, None] * xs + ia[:, 1, 1, None] * ys + it[:, 1, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(b, h * w, c)

    def tap(yi, xi):
        ok = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c)).masked_fill(~ok, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).reshape(b, oh, ow, c)


def _erode(x: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 1:
        return x
    r = k // 2
    xp = F.pad(x[:, None], (r, k - 1 - r, r, k - 1 - r), mode="replicate")
    xp = -F.max_pool2d(-xp, (1, k), stride=1)
    return -F.max_pool2d(-xp, (k, 1), stride=1)[:, 0]


def _blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    if ksize <= 1:
        return x
    r = ksize // 2
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.arange(-r, r + 1)
    kern = np.exp(-(t ** 2) / (2 * sigma ** 2))
    kern = torch.from_numpy((kern / kern.sum()).astype(np.float32)).to(x.device, torch.float64)

    def band(n):
        i = torch.arange(n, device=x.device)
        d = i[:, None] - i[None, :] + r
        return torch.where((d >= 0) & (d < ksize), kern[d.clamp(0, ksize - 1)], 0.0)

    h, w = x.shape[1:]
    y = (x.double() @ band(w)).float()
    return (band(h).T @ y.double()).float()


def edge_radius(matrices: np.ndarray, face_hw) -> int:
    a = np.asarray(matrices, np.float64)[:, :, :2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    area = face_hw[0] * face_hw[1] / max(float(np.abs(det).mean()), 1e-9)
    edge = min(max(int(np.sqrt(area)) // 20, 0), 64)
    return max(8, int(round(edge / 8)) * 8) if edge > 0 else 0


def inverse(matrices: np.ndarray) -> np.ndarray:
    m = np.asarray(matrices, np.float64)
    a, t = m[:, :, :2], m[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    ia = np.stack([a[:, 1, 1], -a[:, 0, 1], -a[:, 1, 0], a[:, 0, 0]],
                  axis=-1).reshape(len(m), 2, 2) / det[:, None, None]
    it = -np.einsum("nij,nj->ni", ia, t)
    return np.concatenate([ia, it[:, :, None]], axis=2)


def paste(frames: torch.Tensor, faces: torch.Tensor, matrices: np.ndarray) -> torch.Tensor:
    """One call: frames (N, H, W, 3) uint8, faces (N, bh, bw, 3) uint8 at
    their box size, frame→crop matrices (N, 2, 3) → (N, H, W, 3) uint8."""
    h, w = frames.shape[1:3]
    edge = edge_radius(matrices, faces.shape[1:3])
    inv = torch.from_numpy(inverse(matrices).astype(np.float32)).to(frames.device)
    out = []
    for i in range(0, len(frames), 8):
        f = faces[i:i + 8].float()
        src = torch.cat([f, torch.ones_like(f[..., :1])], dim=-1)
        warped = _warp(src, inv[i:i + 8], (h, w))
        mask = _erode(warped[..., 3], 2)
        soft = _blur(_erode(mask, edge * 2), edge * 2 + 1) if edge > 0 else mask
        soft = soft[..., None]
        o = soft * (mask[..., None] * warped[..., :3]) + (1.0 - soft) * frames[i:i + 8].float()
        out.append(o.clamp(0.0, 255.0).to(torch.uint8))
    return torch.cat(out)
