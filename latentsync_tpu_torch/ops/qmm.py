"""The int8 matmul with fused dynamic row quantization (K8).

Counterpart of ``latentsync_tpu/ops/qmm.py`` ``quantized_matmul_pallas``:
(M, K) @ W^T with the weight quantized per output channel here, per call
(``wscale = max(|w|, 1e-8) · (1/127)``, a multiply), and the activations
quantized per row inside the kernel (``ascale = max(|x_row|, 1e-8) ·
(1/127)``, ``xq = clip(round(x / ascale), ±127)``), int32 accumulation,
and the dequant ``(acc · ascale) · wscale`` rounded to ``x.dtype`` before
the bias is added in ``x.dtype``: two roundings, as in the reference.

On a CUDA tensor it launches the hand-written kernel of ``csrc/qmm.cu``
(a row-scale pass, then an int8 tensor-core GEMM that quantizes its A
tiles while staging them); on a CPU tensor it runs the plain version,
whose int32 accumulation is a float64 product (exact: |Σ| ≤ 127²·K < 2⁵³).

The weight uses the torch ``nn.Linear`` layout, (N, K).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# the kernel's grid has one row of blocks per 128 rows (gridDim.y ≤ 65535)
_MAX_ROWS = 65535 * 128


def quantize_weight(w: torch.Tensor):
    """(N, K) float → int8 codes (N, K) and f32 per-out-channel scales (N,),
    as ``quantized_matmul_pallas`` quantizes its kernel."""
    wf = w.float()
    wscale = wf.abs().amax(dim=1).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(wf / wscale[:, None]).to(torch.int8), wscale


def quantized_matmul_reference(x2d: torch.Tensor, w: torch.Tensor,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, in the kernel's order of operations."""
    wq, wscale = quantize_weight(w)
    xf = x2d.float()
    ascale = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(xf / ascale).clamp(-127, 127)
    acc = (xq.double() @ wq.double().t()).to(torch.int32)
    out = (acc.float() * ascale * wscale).to(x2d.dtype)
    return out if bias is None else out + bias.to(out.dtype)


def quantized_matmul(x2d: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2d (M, K) bf16 @ w (N, K)^T [+ bias] → (M, N) in x2d.dtype through
    the int8 kernel. See the module docstring."""
    if x2d.device.type == "cpu":
        return quantized_matmul_reference(x2d, w, bias)
    m, k = x2d.shape
    n = w.shape[0]
    if w.shape != (n, k) or k % 8 or m > _MAX_ROWS:
        raise ValueError(f"quantized_matmul: no kernel for x {tuple(x2d.shape)}, "
                         f"w {tuple(w.shape)} (K must be a multiple of 8)")
    x2d = x2d.contiguous()
    wq, wscale = quantize_weight(w)
    b = None if bias is None else bias.to(x2d.dtype).contiguous()
    ascale = torch.empty(m, device=x2d.device, dtype=torch.float32)
    out = torch.empty((m, n), device=x2d.device, dtype=x2d.dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    _build.check_cuda("quantized_matmul", x2d, wq, wscale, ascale, out,
                      dtypes=(bf16, torch.int8, f32, f32, bf16))
    if b is not None:
        _build.check_cuda("quantized_matmul", x2d, b)
    if m == 0:
        return out
    _build.call("ls_quantized_matmul", x2d.data_ptr(), wq.data_ptr(), wscale.data_ptr(),
                _build.ptr(b), m, k, n, ascale.data_ptr(), out.data_ptr(), _build.stream(x2d))
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
