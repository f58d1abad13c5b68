"""Image metrics: PSNR / SSIM (ref:basicsr/metrics/psnr_ssim.py).

Counterpart of ``latentsync_tpu/training/metrics.py``: images in the JAX
package's layout, (H, W, C) or (B, H, W, C), numpy arrays or tensors;
computed in f32 on the images' device, returned as Python floats.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).float()


def psnr(a, b, max_val: float = 255.0) -> float:
    a, b = _f32(a), _f32(b)
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    t = np.arange(size) - size // 2
    k = np.exp(-(t**2) / (2 * sigma**2))
    k = k / k.sum()
    return np.outer(k, k).astype(np.float32)


def ssim(a, b, max_val: float = 255.0) -> float:
    """Single-scale SSIM with the standard 11×11 σ=1.5 Gaussian window over
    the valid region, averaged over pixels and channels."""
    a, b = _f32(a), _f32(b)
    if a.dim() == 3:
        a, b = a[None], b[None]
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    c = a.shape[1]
    k = torch.from_numpy(_gaussian_kernel()).to(a.device)[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, k, groups=c)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a**2
    var_b = filt(b * b) - mu_b**2
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))
