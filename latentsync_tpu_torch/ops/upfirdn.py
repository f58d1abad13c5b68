"""upfirdn2d: upsample → FIR filter → downsample (the StyleGAN2 op).

Counterpart of ``latentsync_tpu/ops/upfirdn.py`` (the reference's CUDA
extensions, ref:basicsr/ops/upfirdn2d/src/upfirdn2d_kernel.cu and
ref:basicsr/ops/fused_act/src/fused_bias_act_kernel.cu). The JAX package
computes it as one ``lax.conv_general_dilated``, reaching no
``pallas_call``; here it is one grouped ``F.conv2d`` on the zero-stuffed,
padded input, in plain torch on either device, no ``torchvision`` op.
Layout is torch's: x (B, C, H, W). Nothing in either package calls it yet
(``models/codeformer.py``'s docstring names it).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """x (B, C, H, W), kernel (kh, kw) FIR filter (an array or a tensor on any
    device), pad (pad0, pad1) on each
    spatial side: insert (up - 1) zeros after every sample, pad (a negative
    pad crops), correlate with `kernel`, keep every `down`-th sample."""
    b, c, h, w = x.shape
    pad0, pad1 = pad
    if up > 1:
        stuffed = x.new_zeros(b, c, h * up, w * up)
        stuffed[:, :, ::up, ::up] = x
        x = stuffed
    x = F.pad(x, (pad0, pad1, pad0, pad1))
    k = kernel if isinstance(kernel, torch.Tensor) else torch.from_numpy(np.asarray(kernel))
    k = k.to(x.device, x.dtype)
    # correlation with `kernel` is a convolution with it flipped, per channel
    k = k.flip(0, 1)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(x, k, stride=down, groups=c)


def _make_resample_kernel(k) -> np.ndarray:
    k = np.asarray(k, np.float64)
    if k.ndim == 1:
        k = np.outer(k, k)
    return (k / k.sum()).astype(np.float32)


def upsample2d(x: torch.Tensor, kernel=(1, 3, 3, 1), factor: int = 2) -> torch.Tensor:
    """StyleGAN2's upsampling (ref:basicsr/ops/upfirdn2d wrapper semantics)."""
    k = _make_resample_kernel(kernel) * (factor**2)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x: torch.Tensor, kernel=(1, 3, 3, 1), factor: int = 2) -> torch.Tensor:
    k = _make_resample_kernel(kernel)
    p = k.shape[0] - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2**0.5) -> torch.Tensor:
    """StyleGAN2's fused bias + LeakyReLU + scale, the bias on the channel
    dim (dim 1)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return F.leaky_relu(x, negative_slope) * scale
