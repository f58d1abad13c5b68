"""Device paste-back: batched inverse warp and soft-mask composite.

Counterpart of ``latentsync_tpu/ops/restore.py`` ``restore_frames_device``,
the reference's restore route whenever the host link is fast (the
pipeline's ``_transport_is_fast``). Frames and faces go to the device as
uint8 and are computed in f32: one bilinear warp of the face with a ones
channel beside it (``utils/face.warp_affine_batch``; the ones channel is
the paste mask), a 2×2 erosion of that mask, a soft mask eroded by a
(2·edge)² window and blurred by a zero-padded separable Gaussian of
2·edge + 1 taps, and the composite, clamped to [0, 255] and truncated to
uint8. PyTorch library ops carry it (gathers, pooling, convolutions):
the reference has no Pallas kernel here.

The edge radius is one per call, from the mean area of the pasted faces,
bucketed to multiples of 8 (at most 64), as the reference has it; so a
call's frames decide each other's pixels, and the caller's grouping is
part of the result. Chunks only bound the device memory a call takes:
the result does not depend on `chunk`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.face import warp_affine_batch


def _min_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k erosion of (B, H, W) masks with replicated borders (cv2.erode's),
    padded (k // 2, k - 1 - k // 2) on each axis: a row minimum, then a
    column minimum (2k comparisons a pixel, not k²; the same minimum)."""
    if k <= 1:
        return x
    r = k // 2
    xp = F.pad(x[:, None], (r, k - 1 - r, r, k - 1 - r), mode="replicate")
    xp = -F.max_pool2d(-xp, (1, k), stride=1)
    return -F.max_pool2d(-xp, (k, 1), stride=1)[:, 0]


def _gaussian_kernel(ksize: int) -> np.ndarray:
    """cv2's Gaussian taps for `ksize` with sigma from its ksize formula."""
    r = ksize // 2
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    t = np.arange(-r, r + 1)
    kern = np.exp(-(t ** 2) / (2 * sigma ** 2))
    return (kern / kern.sum()).astype(np.float32)


def _blur_matrix(n: int, kern: torch.Tensor) -> torch.Tensor:
    """The (n, n) banded matrix of a zero-padded 1-D correlation with
    `kern` (f64, on its device): out[j] = sum_i in[i] · m[i, j]."""
    k = len(kern)
    i = torch.arange(n, device=kern.device)
    d = i[:, None] - i[None, :] + k // 2
    return torch.where((d >= 0) & (d < k), kern[d.clamp(0, k - 1)], 0.0)


def _gaussian_blur(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable Gaussian on (B, H, W) with zero padding: f32 taps, each pass
    accumulated in f64 (as banded matrix products) and rounded to f32. A
    region of ones stays exactly 1.0 on every device (an f32 sum in another
    order may give 1 ± 1 ulp, and the composite then truncates a whole face
    of integer pixels one code lower)."""
    if ksize <= 1:
        return x
    h, w = x.shape[1:]
    kern = torch.from_numpy(_gaussian_kernel(ksize)).to(x.device, torch.float64)
    y = (x.double() @ _blur_matrix(w, kern)).float()
    return (_blur_matrix(h, kern).T @ y.double()).float()


def _restore_kernel(frames_u8: torch.Tensor, faces_u8: torch.Tensor, inv_m: torch.Tensor,
                    edge: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 frames, (B, fh, fw, 3) uint8 faces and (B, 2, 3)
    crop→frame matrices → composited (B, H, W, 3) uint8 frames."""
    h, w = frames_u8.shape[1:3]
    faces = faces_u8.float()
    src = torch.cat([faces, torch.ones_like(faces[..., :1])], dim=-1)
    warped = warp_affine_batch(src, inv_m, (h, w), fill=0.0)
    mask = _min_pool(warped[..., 3], 2)
    soft = mask
    if edge > 0:
        soft = _gaussian_blur(_min_pool(mask, edge * 2), edge * 2 + 1)
    soft = soft[..., None]
    out = soft * (mask[..., None] * warped[..., :3]) + (1.0 - soft) * frames_u8.float()
    return out.clamp_(0.0, 255.0).to(torch.uint8)


def inverse_matrices(matrices: np.ndarray) -> np.ndarray:
    """(N, 2, 3) frame→crop matrices → crop→frame, inverted in float64 on
    the host (``warp_affine_batch`` inverts them once more, in f32)."""
    matrices = np.asarray(matrices, np.float64)
    n = len(matrices)
    a, t = matrices[:, :, :2], matrices[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv_a = np.stack([a[:, 1, 1], -a[:, 0, 1], -a[:, 1, 0], a[:, 0, 0]],
                     axis=-1).reshape(n, 2, 2) / det[:, None, None]
    inv_t = -np.einsum("nij,nj->ni", inv_a, t)
    return np.concatenate([inv_a, inv_t[:, :, None]], axis=2)


def edge_radius(matrices: np.ndarray, face_hw) -> int:
    """The call's erosion / blur radius: sqrt of the mean pasted face area
    over 20, clamped to [0, 64] and, when positive, rounded to a multiple
    of 8 (at least 8)."""
    a = np.asarray(matrices, np.float64)[:, :, :2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    area = face_hw[0] * face_hw[1] / max(float(np.abs(det).mean()), 1e-9)
    edge = min(max(int(np.sqrt(area)) // 20, 0), 64)
    return max(8, int(round(edge / 8)) * 8) if edge > 0 else 0


@torch.inference_mode()
def restore_frames_device(frames: np.ndarray, faces: np.ndarray, matrices: np.ndarray,
                          chunk: int = 8, device=None,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """frames (N, H, W, 3) uint8; faces (N, fh, fw, 3) uint8, already resized
    to their box; matrices (N, 2, 3) forward align (frame→crop) matrices.
    Returns the composited uint8 frames, in `out` when it is given (it may
    be `frames` itself). `device` defaults to the card."""
    device = torch.device("cuda" if device is None else device)
    n = len(frames)
    inv_m = inverse_matrices(matrices).astype(np.float32)
    edge = edge_radius(matrices, faces.shape[1:3])
    if out is None:
        out = np.empty_like(frames)
    for i in range(0, n, chunk):
        sl = slice(i, min(i + chunk, n))
        res = _restore_kernel(torch.from_numpy(np.ascontiguousarray(frames[sl])).to(device),
                              torch.from_numpy(np.ascontiguousarray(faces[sl])).to(device),
                              torch.from_numpy(inv_m[sl]).to(device), edge)
        out[sl] = res.cpu().numpy()
    return out
