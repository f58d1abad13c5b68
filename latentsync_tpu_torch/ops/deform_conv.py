"""Modulated deformable convolution v2 (DCNv2) as gather + einsum.

Counterpart of ``latentsync_tpu/ops/deform_conv.py`` (the reference's CUDA
extension, ref:basicsr/ops/dcn/src/deform_conv_cuda_kernel.cu and its
autograd wrapper ref:basicsr/ops/dcn/deform_conv.py:27). The JAX package
computes it in plain jnp, reaching no ``pallas_call``, and so does this
port in plain torch, on either device: every kernel tap samples the input
bilinearly at its offset position (one batched index gather, zero outside
the image), the samples are scaled by the modulation mask, and one
``einsum`` contracts them with the weight. Autograd differentiates it. No
``torchvision`` op. Layout is torch's: x (B, Cin, H, W), offset (B, 2·kh·kw,
Ho, Wo) as (y, x) pairs per tap (the torchvision / basicsr layout), mask
(B, kh·kw, Ho, Wo), weight (Cout, Cin, kh, kw). Nothing in either package
calls it yet (``models/codeformer.py``'s docstring names it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _bilinear_gather(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W); xs / ys (B, ...) sample coords → (B, ..., C),
    bilinear, zero outside the image."""
    b, c, h, w = img.shape
    flat = img.permute(0, 2, 3, 1).reshape(b, h * w, c)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]

    def at(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return vals.reshape(*idx.shape, c) * valid[..., None]

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                            stride: int = 1, padding: int = 1,
                            dilation: int = 1) -> torch.Tensor:
    """DCNv2 forward: (B, Cout, Ho, Wo) in x.dtype, accumulated in f32."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev = x.device
    # base sampling grid: output position → kernel tap coords (Ho, Wo, kh, kw)
    ys = torch.arange(ho, device=dev) * stride - padding
    xs = torch.arange(wo, device=dev) * stride - padding
    ky = torch.arange(kh, device=dev) * dilation
    kx = torch.arange(kw, device=dev) * dilation
    base_y = (ys[:, None, None, None] + ky[None, None, :, None]).expand(ho, wo, kh, kw).float()
    base_x = (xs[None, :, None, None] + kx[None, None, None, :]).expand(ho, wo, kh, kw).float()
    off = offset.float().reshape(b, kh, kw, 2, ho, wo).permute(0, 4, 5, 1, 2, 3)
    samp_y = base_y[None] + off[..., 0]
    samp_x = base_x[None] + off[..., 1]
    cols = _bilinear_gather(x.float(), samp_x, samp_y)  # (B, Ho, Wo, kh, kw, Cin)
    m = mask.float().reshape(b, kh, kw, ho, wo).permute(0, 3, 4, 1, 2)
    cols = cols * m[..., None]
    out = torch.einsum("bhwyxc,ocyx->bohw", cols, weight.float())
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(x.dtype)


def dcn_v2_pack(x: torch.Tensor, weight_offset: torch.Tensor,
                bias_offset: Optional[torch.Tensor], weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                dilation: int = 1) -> torch.Tensor:
    """ModulatedDeformConvPack-style (ref:basicsr/ops/dcn/deform_conv.py
    DCNv2Pack): a plain convolution of x (weight_offset (3·kh·kw, Cin, kh,
    kw)) predicts the y offsets, the x offsets and the mask logits, in three
    channel blocks; the offsets interleave into (y, x) pairs per tap and the
    mask goes through a sigmoid."""
    kh, kw = weight.shape[2:]
    pred = F.conv2d(x, weight_offset, bias_offset, stride, padding, dilation)
    o1, o2, m = torch.chunk(pred, 3, dim=1)
    b, _, ho, wo = o1.shape
    offset = torch.stack([o1, o2], dim=2).reshape(b, 2 * kh * kw, ho, wo)
    return modulated_deform_conv2d(x, offset, torch.sigmoid(m), weight, bias, stride, padding,
                                   dilation)
