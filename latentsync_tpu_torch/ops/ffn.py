"""GEGLU feed-forward with the LayerNorm and residual folded in (K1), the
fused q/k/v projection (K9) and the int8-in/int8-out GEGLU (K10).

Counterpart of ``latentsync_tpu/ops/ffn.py`` ``geglu_ffn``. On a CUDA
tensor it launches the hand-written kernel chain of ``csrc/geglu.cu``
(the LayerNorm row pass into a scratch buffer, up-projection + GEGLU
epilogue, down-projection + bias + residual epilogue); on a CPU tensor it
runs the plain version below. Either way it differentiates as the
reference's ``custom_vjp`` does (``ffn.py:208-224``): the backward
recomputes the composed ``geglu_ffn_xla_full`` (``_geglu_xla_full``) and
takes its gradient (``ops/autograd.py``). ``geglu_route`` is the
reference's own choice between its kernel and that composition
(``_pick_geglu_blocks``), for callers that follow it at shapes the served
UNet never gives (SyncNet's feed-forwards).

Where the reference runs its composed FF instead (``LATENTSYNC_FUSED_FFN=0``
or an int8 dense mode, ``unet3d.py:273``), the UNet calls
``geglu_ffn_composed`` with the projection it is given.

Weights use the torch ``nn.Linear`` layout: ``w_up`` is (2·inner, C)
with the value half first and the gate half second (diffusers GEGLU),
``w_down`` is (C, inner).

``qkv_proj`` (K9, ``csrc/qkv_proj.cu``) and ``geglu_ffn_int8io`` with
``quantize_rowwise`` (K10, ``csrc/geglu_i8.cu``) are the reference's
kernel-probe prototypes: no model calls them, ``scripts/micro_probe.py``
does. Both launch their kernel on a CUDA tensor and run their plain
version on a CPU tensor. K9 differentiates as the reference's ``_qkv_fwd``
/ ``_qkv_bwd`` do (``ffn.py:278-311``): the backward is the VJP of the
three products (``qkv_proj_composed``, ``_qkv_xla``). K10 has no
gradient in either package, so its launch under grad with an input that
requires grad raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .autograd import with_composed_grad

# the widest C of K10 (csrc/geglu_i8.cu): one launch up to
# GEGLU_I8_GROUP_C, whose f32 result fits the registers of two warpgroups;
# above it the blocks split the output columns, write the f32 result to a
# scratch buffer, and a row pass of the same file quantizes it
GEGLU_I8_MAX_C = 1280
GEGLU_I8_GROUP_C = 640
# rows the wrappers take; the GEMM template itself refuses a product whose
# row offsets (rows x pitch) pass 32 bits, and the wrapper then raises
_MAX_ROWS = 65535 * 128


def fused_ffn_enabled() -> bool:
    """The reference's switch: on unless ``LATENTSYNC_FUSED_FFN=0``."""
    return os.environ.get("LATENTSYNC_FUSED_FFN", "1") != "0"


def linear(x: torch.Tensor, w, b, dtype: torch.dtype) -> torch.Tensor:
    """The float projection x @ w^T [+ b] with the weights cast to `dtype`."""
    return F.linear(x, w.to(dtype), None if b is None else b.to(dtype))


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: f32, or f64 for f64 inputs
    (``torch.autograd.gradcheck``)."""
    return torch.promote_types(t.dtype, torch.float32)


def layer_norm_f32(x: torch.Tensor, scale, bias, eps: float) -> torch.Tensor:
    """f32 LayerNorm with the reference's two-pass statistics."""
    acc = acc_dtype(x)
    xf = x.to(acc)
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.to(acc) + bias.to(acc)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale=None,
                        ln_bias=None, residual: bool = False,
                        eps: float = 1e-6) -> torch.Tensor:
    """Plain version: f32 products and activations, rounded to x.dtype
    where the kernel rounds (normalised input, hidden, output)."""
    dt, acc = x.dtype, acc_dtype(x)
    inner = w_up.shape[0] // 2
    h = x if ln_scale is None else layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    up = h.to(acc) @ w_up.to(acc).t() + b_up.to(acc)
    hidden = (up[..., :inner] * gelu_erf(up[..., inner:])).to(dt)
    out = hidden.to(acc) @ w_down.to(acc).t() + b_down.to(acc)
    if residual:
        out = out + x.to(acc)
    return out.to(dt)


def geglu_ffn_xla_full(x: torch.Tensor, w_up, b_up, w_down, b_down, ln_scale=None,
                       ln_bias=None, residual: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_geglu_xla_full``, the composition its kernel's
    gradient differentiates (and what it runs where ``geglu_route`` says
    no): f32 LN cast to x.dtype, the projections with the weights and
    biases cast to x.dtype, the exact GELU written with erfc as jax's, and
    the residual added in f32."""
    dt = x.dtype
    h = x if ln_scale is None else layer_norm_f32(x, ln_scale, ln_bias, eps).to(dt)
    value, gate = linear(h, w_up, b_up, dt).chunk(2, dim=-1)
    out = linear(value * (0.5 * gate * torch.erfc(-gate * math.sqrt(0.5))), w_down, b_down, dt)
    if residual:
        acc = acc_dtype(x)
        out = (x.to(acc) + out.to(acc)).to(dt)
    return out


def geglu_route(m: int, c: int) -> bool:
    """Whether the reference ran its GEGLU kernel for M rows of width C
    (``_pick_geglu_blocks(m, c, 4c) != (0, 0)``: M a multiple of 128 and a
    block pair under its 12 MB VMEM budget); where it did not, it ran
    ``_geglu_xla_full``."""
    inner = 4 * c
    for bm in (512, 256, 128):
        if m % bm:
            continue
        for bi in (2048, 1280, 1024, 640, 512, 256):
            if inner % bi == 0 and (3 * c * bi * 4 + 3 * bm * bi * 4 + bm * c * 6
                                    <= 12 * 2**20):
                return True
    return False


def geglu_ffn(x: torch.Tensor, w_up, b_up, w_down, b_down,
              ln_scale: Optional[torch.Tensor] = None,
              ln_bias: Optional[torch.Tensor] = None,
              residual: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., C) → (x +) FF(LN(x)). See the module docstring."""
    def run(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias):
        if x.device.type == "cpu":
            return geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias,
                                       residual, eps)
        return _geglu_ffn_kernel(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias, residual,
                                 eps)

    def composed(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias):
        return geglu_ffn_xla_full(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias, residual,
                                  eps)

    return with_composed_grad(run, composed, x, w_up, b_up, w_down, b_down, ln_scale, ln_bias)


def _geglu_ffn_kernel(x: torch.Tensor, w_up, b_up, w_down, b_down, ln_scale, ln_bias,
                      residual: bool, eps: float) -> torch.Tensor:
    """K1's launch (``geglu_ffn`` on a CUDA tensor)."""
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
    _build.refuse_grad("geglu_ffn", x, w_up, b_up, w_down, b_down, ln_scale, ln_bias)
    _build.check_cuda("geglu_ffn", x2, w_up, w_down)
    m = x2.shape[0]
    has_ln = ln_scale is not None
    f32 = dict(device=x.device, dtype=torch.float32)
    ln_w = ln_scale.to(**f32).contiguous() if has_ln else None
    ln_b = ln_bias.to(**f32).contiguous() if has_ln else None
    # every buffer the kernels read stays referenced until after the launch
    b_up = b_up.to(**f32).contiguous()
    b_down = b_down.to(**f32).contiguous()
    # scratch of the chain: bf16(LN(x)), written once by the row pass
    normed = torch.empty_like(x2) if has_ln else None
    hidden = torch.empty((m, inner), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x2)
    _build.call(
        "ls_geglu_ffn", x2.data_ptr(), m, c, w_up.data_ptr(), b_up.data_ptr(),
        w_down.data_ptr(), b_down.data_ptr(), _build.ptr(ln_w),
        _build.ptr(ln_b), eps, int(residual), _build.ptr(normed),
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


# ---------------------------------------------------------------------------
# K9: fused q/k/v projection
# ---------------------------------------------------------------------------


def qkv_proj_reference(x, wq, wk, wv):
    """Plain version: three f32 products, each rounded to x.dtype."""
    acc = acc_dtype(x)
    xf = x.to(acc)
    return tuple((xf @ w.to(acc).t()).to(x.dtype) for w in (wq, wk, wv))


def qkv_proj_composed(x, wq, wk, wv):
    """The reference's ``_qkv_xla``: three products in x.dtype, the weights
    cast to it (the function ``_qkv_bwd`` differentiates)."""
    return tuple(F.linear(x, w.to(x.dtype)) for w in (wq, wk, wv))


def qkv_proj(x: torch.Tensor, wq, wk, wv):
    """x: (..., C); wq, wk, wv: (inner, C), no bias → three (..., inner):
    one launch that reads x once for the three products; differentiated as
    ``qkv_proj_composed``."""
    kernel = qkv_proj_reference if x.device.type == "cpu" else _qkv_kernel
    return with_composed_grad(kernel, qkv_proj_composed, x, wq, wk, wv)


def _qkv_kernel(x: torch.Tensor, wq, wk, wv):
    c = x.shape[-1]
    inner = wq.shape[0]
    if any(w.shape != (inner, c) for w in (wq, wk, wv)) or c % 8 or inner % 8:
        raise ValueError(f"qkv_proj: weights {[tuple(w.shape) for w in (wq, wk, wv)]} do not "
                         f"fit C={c} (C and inner must be multiples of 8)")
    x2 = x.reshape(-1, c).contiguous()
    ws = [w.contiguous() for w in (wq, wk, wv)]
    m = x2.shape[0]
    outs = [torch.empty((m, inner), device=x.device, dtype=x.dtype) for _ in range(3)]
    _build.check_cuda("qkv_proj", x2, *ws, *outs)
    if m > _MAX_ROWS:
        raise ValueError(f"qkv_proj: {m} rows exceed the grid")
    _build.call("ls_qkv_proj", x2.data_ptr(), *(w.data_ptr() for w in ws),
                *(o.data_ptr() for o in outs), m, c, inner, _build.stream(x))
    qkv_proj.launches += 1
    shape = x.shape[:-1] + (inner,)
    return tuple(o.reshape(shape) for o in outs)


qkv_proj.launches = 0

# ---------------------------------------------------------------------------
# K10: int8-in / int8-out GEGLU
# ---------------------------------------------------------------------------


def quantize_rowwise(x: torch.Tensor):
    """(M, C) float → (int8 codes (M, C), f32 scales (M, 1)), symmetric per
    row: ``s = max|row| / 127 + 1e-12``, ``codes = round(x / s)`` (ties to
    even; no clamp is needed). An all-zero row gives s = 1e-12 and zero
    codes. Plain torch on either device: it is no kernel of the reference."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.round(xf / s).to(torch.int8), s


def geglu_ffn_int8io_reference(x_i8, x_scale, w_up, b_up, w_down, b_down):
    """Plain version, rounding where the kernel rounds: the dequantized x,
    the weights and the hidden to bf16, every product and the result in
    f32, then ``quantize_rowwise``."""
    bf = torch.bfloat16
    inner = w_up.shape[0] // 2
    x = (x_i8.float() * x_scale.float().reshape(-1, 1)).to(bf)
    up = x.float() @ w_up.to(bf).float().t() + b_up.float()
    hidden = (up[:, :inner] * gelu_erf(up[:, inner:])).to(bf)
    res = hidden.float() @ w_down.to(bf).float().t() + b_down.float()
    return quantize_rowwise(res)


def geglu_ffn_int8io(x_i8: torch.Tensor, x_scale: torch.Tensor, w_up, b_up, w_down, b_down):
    """(x_i8 (M, C) int8, x_scale (M, 1) f32) → (out_i8 (M, C), out_scale
    (M, 1)): GEGLU on rowwise-quantized activations, weights in bf16
    (layouts as ``geglu_ffn``). The output feeds the next call as it is.
    On the card, for C % 8 == 0: one launch that keeps x, the hidden and the
    f32 result on chip up to ``GEGLU_I8_GROUP_C``; up to ``GEGLU_I8_MAX_C``
    the column-split launch writes its f32 result to a scratch buffer that
    the row pass quantizes."""
    if x_i8.device.type == "cpu":
        return geglu_ffn_int8io_reference(x_i8, x_scale, w_up, b_up, w_down, b_down)
    if x_i8.dim() != 2:
        raise ValueError(f"geglu_ffn_int8io: expected (M, C) codes, got {tuple(x_i8.shape)}")
    m, c = x_i8.shape
    inner = w_up.shape[0] // 2
    if (w_up.shape != (2 * inner, c) or inner != 4 * c or w_down.shape != (c, inner)
            or x_scale.numel() != m):
        raise ValueError(f"geglu_ffn_int8io: weights {tuple(w_up.shape)}, {tuple(w_down.shape)} "
                         f"or scales {tuple(x_scale.shape)} do not fit x {tuple(x_i8.shape)}")
    if c % 8 or c > GEGLU_I8_MAX_C or m * c >= 2**31:
        raise ValueError(f"geglu_ffn_int8io: no kernel for M={m}, C={c} (C % 8 must be 0, "
                         f"C <= {GEGLU_I8_MAX_C})")
    dev = x_i8.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    x_i8 = x_i8.contiguous()
    xs = x_scale.reshape(m).contiguous()
    # every buffer the kernel reads stays referenced until after the launch
    w_up = w_up.to(bf).contiguous()
    w_down = w_down.to(bf).contiguous()
    b_up = b_up.to(device=dev, dtype=f32).contiguous()
    b_down = b_down.to(device=dev, dtype=f32).contiguous()
    out = torch.empty((m, c), device=dev, dtype=i8)
    out_scale = torch.empty((m, 1), device=dev, dtype=f32)
    _build.check_cuda("geglu_ffn_int8io", x_i8, xs, w_up, b_up, w_down, b_down, out, out_scale,
                      dtypes=(i8, f32, bf, f32, bf, f32, i8, f32))
    if m == 0:
        return out, out_scale
    res = torch.empty((m, c), device=dev, dtype=f32) if c > GEGLU_I8_GROUP_C else None
    _build.call("ls_geglu_ffn_int8io", x_i8.data_ptr(), xs.data_ptr(), m, c, w_up.data_ptr(),
                b_up.data_ptr(), w_down.data_ptr(), b_down.data_ptr(), out.data_ptr(),
                out_scale.data_ptr(), _build.ptr(res), _build.stream(x_i8))
    geglu_ffn_int8io.launches += 1
    return out, out_scale


geglu_ffn_int8io.launches = 0
