"""Int8 execution: the reference's two switches and the ops they select.

Counterpart of ``latentsync_tpu/ops/qconv.py``. Both switches keep the
reference's names and default (off) and are read at each call:

- ``LATENTSYNC_INT8=1`` sends every ``QConv`` (here :class:`QConv2d`, an
  ``nn.Conv2d`` with the same parameters) through :func:`quantized_conv2d`:
  per-out-channel weight scales, per-sample activation scales over
  (C, H, W), int32 accumulation, dequant and bias in f32, cast to x.dtype.
- ``LATENTSYNC_INT8_DENSE`` selects the projection of
  :func:`dense_with_params`: ``""`` the float product, ``"1"``/``"xla"``
  the reference's ``_qdense_ste`` scheme (per-row activation scales), and
  ``"pallas"`` the K8 kernel (``ops/qmm.py``). Any other value raises; the
  reference would quietly run ``"xla"`` for it.

Both routes train as the reference's straight-through rules do
(``_qdense_ste``, ``_qdense_pallas_ste``, ``_qconv2d_ste``,
``qconv.py:150-202``, ``:237-272``): :class:`QDenseSTE` and
:class:`QConvSTE` run the int8 forward (grad off inside it) and save only
x, w and the bias; their backward is the gradient of the float product
(:func:`float_dense`, :func:`float_conv`: f32 with the bias in f32, rounded
to x.dtype), on both devices. ``round`` alone has a zero gradient, so
without the rule the gradient would flow only through the scales' amax.
``torch.autograd.gradcheck`` cannot hold such a Function (its backward is
not the forward's derivative); the tests hold it against ``jax.vjp`` of
the reference's rules.

The int32 accumulation runs, on a CUDA tensor, as ``torch._int_mm`` (for
the convolution after a frame-chunked im2col, so the int8 column buffer
and its int32 product stay under ~1 GiB); K and N are zero-padded to
multiples of 8, which is exact. The reference computes these products
with XLA, outside any Pallas kernel. On a CPU tensor the plain versions
convolve or multiply the int8 codes in float64, which is exact
(|Σ| ≤ 127²·K < 2⁵³), and cast to int32.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .autograd import ComposedGrad
from .ffn import linear
from .qmm import quantized_matmul

# the im2col buffer and the int32 product of one frame chunk, in bytes
_CHUNK_BYTES = 2**30
_DENSE_MODES = {"": "", "1": "xla", "xla": "xla", "pallas": "pallas"}


def int8_enabled() -> bool:
    return os.environ.get("LATENTSYNC_INT8") == "1"


def int8_dense_mode() -> str:
    """"" (off), "xla" (also spelled "1") or "pallas"; raises otherwise."""
    mode = os.environ.get("LATENTSYNC_INT8_DENSE", "")
    if mode not in _DENSE_MODES:
        raise ValueError(f"LATENTSYNC_INT8_DENSE={mode!r}: expected '', '1', 'xla' or "
                         "'pallas'")
    return _DENSE_MODES[mode]


def int8_dense_enabled() -> bool:
    return int8_dense_mode() != ""


def _quantize(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of f32 `xf` with one scale per slice over `dims`
    (``max(amax, 1e-8) / 127``, a divide)."""
    scale = xf.abs().amax(dim=dims, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def _pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if t.shape[dim] >= size:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, size - t.shape[dim]]
    return F.pad(t, pad)


def int_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (N, K)^T int8 → (M, N) int32, in float64 (exact)."""
    return (a.double() @ b.double().t()).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (N, K)^T int8 → (M, N) int32: ``torch._int_mm``
    on a CUDA tensor (K and N padded to multiples of 8 and M past 16, as it
    requires), the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return int_mm_reference(a, b)
    m, k = a.shape
    n = b.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    a = _pad_dim(_pad_dim(a, 1, kp), 0, 17).contiguous()
    b = _pad_dim(_pad_dim(b, 1, kp), 0, np_).contiguous()
    return torch._int_mm(a, b.t())[:m, :n]


def conv_acc_reference(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """int32 accumulators (N, Cout, Ho, Wo) of int8 `xq` (N, Cin, H, W) and
    `wq` (Cout, Cin, kh, kw), as a float64 convolution (exact)."""
    return F.conv2d(xq.double(), wq.double(), None, stride, padding).to(torch.int32)


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride, padding) -> torch.Tensor:
    """The int32 accumulators of :func:`conv_acc_reference`; on a CUDA tensor
    one im2col of all of `xq` and one ``torch._int_mm`` (callers bound the
    frames with :func:`chunk_frames`)."""
    if xq.device.type == "cpu":
        return conv_acc_reference(xq, wq, stride, padding)
    (sh, sw), (ph, pw) = stride, padding
    cout, cin, kh, kw = wq.shape
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    cols = xq.unfold(2, kh, sh).unfold(3, kw, sw)  # (N, Cin, Ho, Wo, kh, kw)
    n, _, ho, wo = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, cin * kh * kw)
    acc = int_mm(cols, wq.reshape(cout, cin * kh * kw))
    conv_acc.launches += 1
    return acc.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


conv_acc.launches = 0


def chunk_frames(ho: int, wo: int, k: int, cout: int) -> int:
    """Frames whose im2col (Ho·Wo·K int8) and product (Ho·Wo·Cout int32,
    both padded to multiples of 8) fit the chunk budget."""
    per_frame = ho * wo * (-(-k // 8) * 8 + 4 * (-(-cout // 8) * 8))
    return max(1, _CHUNK_BYTES // per_frame)


class QConvSTE(ComposedGrad):
    """The reference's ``_qconv2d_ste``: ``apply(int8_forward, float_conv,
    x, w, bias)`` with the stride and padding bound in both callables."""


class QDenseSTE(ComposedGrad):
    """The reference's ``_qdense_ste`` / ``_qdense_pallas_ste``:
    ``apply(int8_forward, float_dense, x2d, w, bias)``."""


def float_conv(x, w, bias, stride, padding) -> torch.Tensor:
    """``_float_conv``: the f32 convolution with the bias added in f32,
    rounded to x.dtype: the function whose gradient the int8 convolution
    takes."""
    b = None if bias is None else bias.float()
    return F.conv2d(x.float(), w.float(), b, stride, padding).to(x.dtype)


def float_dense(x2d, w, bias) -> torch.Tensor:
    """``_qdense_ste_bwd``'s ``float_dense``: the f32 product with the bias
    added in f32, rounded to x.dtype."""
    b = None if bias is None else bias.float()
    return F.linear(x2d.float(), w.float(), b).to(x2d.dtype)


def _qconv2d_int8(x, w, bias, stride, padding) -> torch.Tensor:
    wq, wscale = _quantize(w.float(), (1, 2, 3))
    wscale = wscale.reshape(1, -1, 1, 1)
    n, _, h, wd = x.shape
    cout, cin, kh, kw = w.shape
    (sh, sw), (ph, pw) = stride, padding
    ho, wo = (h + 2 * ph - kh) // sh + 1, (wd + 2 * pw - kw) // sw + 1
    step = n if x.device.type == "cpu" else chunk_frames(ho, wo, cin * kh * kw, cout)
    out = torch.empty((n, cout, ho, wo), device=x.device, dtype=x.dtype)
    for i in range(0, n, step):
        # per-sample scales: a chunk of frames quantizes on its own
        xq, ascale = _quantize(x[i:i + step].float(), (1, 2, 3))
        acc = conv_acc(xq, wq, (sh, sw), (ph, pw))
        y = acc.float() * (wscale * ascale)
        if bias is not None:
            y = y + bias.float()[None, :, None, None]
        out[i:i + step] = y.to(x.dtype)
    return out


def quantized_conv2d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                     stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """x (N, Cin, H, W) float, w (Cout, Cin, kh, kw) float → the int8
    convolution in x.dtype (``_qconv2d_ste``'s forward), differentiated
    straight through (:class:`QConvSTE`). Zero padding applies to the int8
    codes; it moves no scale."""
    stride, padding = tuple(stride), tuple(padding)
    return QConvSTE.apply(
        lambda x, w, b: _qconv2d_int8(x, w, b, stride, padding),
        lambda x, w, b: float_conv(x, w, b, stride, padding), x, w, bias)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs :func:`quantized_conv2d` under
    ``LATENTSYNC_INT8=1`` (the reference's ``QConv``); the same parameters
    either way."""

    def forward(self, x):
        if int8_enabled():
            return quantized_conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return super().forward(x)


def _qdense_int8(x2d: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]):
    wq, wscale = _quantize(w.float(), 1)
    xq, ascale = _quantize(x2d.float(), 1)
    out = int_mm(xq, wq).float() * (wscale.t() * ascale)
    if bias is not None:
        out = out + bias.float()
    return out.to(x2d.dtype)


def _qdense_xla(x2d: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]):
    """The reference's ``_qdense_ste``: per-row activation scales,
    per-out-channel weight scales (both divides), bias added in f32;
    differentiated straight through (:class:`QDenseSTE`)."""
    return QDenseSTE.apply(_qdense_int8, float_dense, x2d, w, bias)


def dense_with_params(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T [+ b] → (..., N) in `dtype`, through the
    projection ``LATENTSYNC_INT8_DENSE`` selects (the reference's QDense)."""
    mode = int8_dense_mode()
    if not mode:
        return linear(x.to(dtype), w, b, dtype)
    x2d = x.reshape(-1, x.shape[-1])
    if mode == "pallas":  # K8 (``_qdense_pallas_ste``)
        out = QDenseSTE.apply(quantized_matmul, float_dense, x2d, w, b)
    else:
        out = _qdense_xla(x2d, w, b)
    return out.to(dtype).reshape(*x.shape[:-1], w.shape[0])
