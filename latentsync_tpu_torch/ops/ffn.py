"""GEGLU feed-forward with the LayerNorm and residual folded in (K1).

Counterpart of ``latentsync_tpu/ops/ffn.py`` ``geglu_ffn``. On a CUDA
tensor it launches the hand-written kernel chain of ``csrc/geglu.cu``
(LN stats, up-projection + GEGLU epilogue, down-projection + bias +
residual epilogue); on a CPU tensor it runs the plain version below.

Where the reference runs its composed FF instead (``LATENTSYNC_FUSED_FFN=0``
or an int8 dense mode, ``unet3d.py:273``), the UNet calls
``geglu_ffn_composed`` with the projection it is given.

Weights use the torch ``nn.Linear`` layout: ``w_up`` is (2·inner, C)
with the value half first and the gate half second (diffusers GEGLU),
``w_down`` is (C, inner).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def fused_ffn_enabled() -> bool:
    """The reference's switch: on unless ``LATENTSYNC_FUSED_FFN=0``."""
    return os.environ.get("LATENTSYNC_FUSED_FFN", "1") != "0"


def linear(x: torch.Tensor, w, b, dtype: torch.dtype) -> torch.Tensor:
    """The float projection x @ w^T [+ b] with the weights cast to `dtype`."""
    return F.linear(x, w.to(dtype), None if b is None else b.to(dtype))


def layer_norm_f32(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """f32 LayerNorm with the reference's two-pass statistics."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale=None,
                        ln_bias=None, residual: bool = False,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 products and activations, rounded to x.dtype
    where the kernel rounds (normalised input, hidden, output)."""
    dt = x.dtype
    inner = w_up.shape[0] // 2
    h = x if ln_scale is None else layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    up = h.float() @ w_up.float().t() + b_up.float()
    hidden = (up[..., :inner] * gelu_erf(up[..., inner:])).to(dt)
    out = hidden.float() @ w_down.float().t() + b_down.float()
    if residual:
        out = out + x.float()
    return out.to(dt)


def geglu_ffn(x: torch.Tensor, w_up, b_up, w_down, b_down,
              ln_scale: Optional[torch.Tensor] = None,
              ln_bias: Optional[torch.Tensor] = None,
              residual: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., C) → (x +) FF(LN(x)). See the module docstring."""
    if x.device.type == "cpu":
        return geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale,
                                   ln_bias, residual, eps)
    c = x.shape[-1]
    inner = w_up.shape[0] // 2
    if w_up.shape != (2 * inner, c) or inner != 4 * c or w_down.shape != (c, inner):
        raise ValueError(f"geglu_ffn: weights {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not fit C={c}")
    if c % 8:
        raise ValueError(f"geglu_ffn: C={c} must be a multiple of 8")
    x2 = x.reshape(-1, c).contiguous()
    w_up = w_up.contiguous()
    w_down = w_down.contiguous()
    _build.check_cuda("geglu_ffn", x2, w_up, w_down)
    m = x2.shape[0]
    has_ln = ln_scale is not None
    f32 = dict(device=x.device, dtype=torch.float32)
    ln_w = ln_scale.to(**f32).contiguous() if has_ln else None
    ln_b = ln_bias.to(**f32).contiguous() if has_ln else None
    # every buffer the kernels read stays referenced until after the launch
    b_up = b_up.to(**f32).contiguous()
    b_down = b_down.to(**f32).contiguous()
    stats = torch.empty((m, 2), **f32) if has_ln else None
    hidden = torch.empty((m, inner), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x2)
    _build.call(
        "ls_geglu_ffn", x2.data_ptr(), m, c, w_up.data_ptr(), b_up.data_ptr(),
        w_down.data_ptr(), b_down.data_ptr(), _build.ptr(ln_w),
        _build.ptr(ln_b), eps, int(residual), _build.ptr(stats),
        hidden.data_ptr(), out.data_ptr(), _build.stream(x))
    geglu_ffn.launches += 1
    return out.reshape(x.shape)


geglu_ffn.launches = 0


def geglu_ffn_composed(x: torch.Tensor, w_up, b_up, w_down, b_down, ln_scale, ln_bias,
                       eps: float = 1e-6, dense=linear) -> torch.Tensor:
    """The reference's composed GEGLU FF (``unet3d.py:278-290``): f32 LN cast
    to x.dtype, the up-projection, ``value * gelu(gate)`` in x.dtype (exact
    GELU written as jax's, with erfc), the down-projection, and x + ff.
    `dense(x, w, b, dtype)` is the projection (``qconv.dense_with_params``
    in the int8 dense modes)."""
    dt = x.dtype
    h = layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    value, gate = dense(h, w_up, b_up, dt).chunk(2, dim=-1)
    hidden = value * (0.5 * gate * torch.erfc(-gate * math.sqrt(0.5)))
    return x + dense(hidden, w_down, b_down, dt)
