"""The int8 matmul with fused dynamic row quantization (K8).

Counterpart of ``latentsync_tpu/ops/qmm.py`` ``quantized_matmul_pallas``:
(M, K) @ W^T with the weight quantized per output channel at every call
(``wscale = max(|w|, 1e-8) · (1/127)``, a multiply), the activations per
row (``ascale = max(|x_row|, 1e-8) · (1/127)``, ``xq = clip(round(x /
ascale), ±127)``), int32 accumulation, and the dequant ``(acc · ascale) ·
wscale`` rounded to ``x.dtype`` before the bias is added in ``x.dtype``:
two roundings, as in the reference.

On a CUDA tensor it launches the hand-written kernels of ``csrc/qmm.cu``:
one quantizing row pass over the rows of x and of w (codes at a pitch of K
rounded up to 16, zero tail: :func:`quantize_rows_reference` is its plain
version), then the int8 mode of the GEMM template. On a CPU tensor it runs
the plain version, whose int32 accumulation is a float64 product (exact:
|Σ| ≤ 127²·K < 2⁵³).

The weight uses the torch ``nn.Linear`` layout, (N, K). K8 has no
gradient in this package yet (the reference's ``QDense`` is
straight-through, ``qconv.py:237-272``): its launch under grad with an
input that requires grad raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build


def code_pitch(k: int) -> int:
    """Row pitch of the int8 codes: K rounded up to whole 16-byte copies."""
    return -(-k // 16) * 16


def quantize_rows_reference(t: torch.Tensor, pitch: Optional[int] = None):
    """Plain version of the kernel's row pass: (R, K) float → int8 codes
    (R, pitch) with zeros past K, and f32 row scales (R,);
    ``scale = max(max|row|, 1e-8) · (1/127)``, ``code = clip(round(row /
    scale), ±127)``. For a weight the clip changes nothing: every
    ``|row / scale|`` rounds to at most 127."""
    tf = t.float()
    scale = tf.abs().amax(dim=1).clamp_min(1e-8) * (1.0 / 127.0)
    codes = torch.round(tf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    pitch = t.shape[1] if pitch is None else pitch
    out = torch.zeros((t.shape[0], pitch), dtype=torch.int8, device=t.device)
    out[:, :t.shape[1]] = codes
    return out, scale


def quantize_weight(w: torch.Tensor):
    """(N, K) float → int8 codes (N, K) and f32 per-out-channel scales (N,),
    as ``quantized_matmul_pallas`` quantizes its kernel."""
    wf = w.float()
    wscale = wf.abs().amax(dim=1).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(wf / wscale[:, None]).to(torch.int8), wscale


def quantize_activations(x2d: torch.Tensor):
    """(M, K) float → codes (M, K) as f32 values and f32 row scales (M, 1),
    as ``quantized_matmul_pallas``'s kernel quantizes its row block."""
    xf = x2d.float()
    ascale = xf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(xf / ascale).clamp(-127, 127), ascale


def quantized_matmul_reference(x2d: torch.Tensor, w: torch.Tensor,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, in the kernel's order of operations."""
    wq, wscale = quantize_weight(w)
    xq, ascale = quantize_activations(x2d)
    acc = (xq.double() @ wq.double().t()).to(torch.int32)
    out = (acc.float() * ascale * wscale).to(x2d.dtype)
    return out if bias is None else out + bias.to(out.dtype)


def _scratch(m: int, n: int, kp: int, device) -> tuple[torch.Tensor, list[int]]:
    """One buffer for the row pass's output: xq (m, kp), wq (n, kp) int8,
    ascale (m), wscale (n) f32, each at a 16-byte aligned offset; the
    buffer and the four addresses."""
    sizes = [m * kp, n * kp, 4 * m, 4 * n]
    offs, total = [], 0
    for size in sizes:
        offs.append(total)
        total += -(-size // 16) * 16
    buf = torch.empty(total, device=device, dtype=torch.uint8)
    return buf, [buf.data_ptr() + o for o in offs]


def quantized_matmul(x2d: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2d (M, K) bf16 @ w (N, K)^T (bf16 or f32) [+ bias] → (M, N) bf16
    through the int8 kernels. See the module docstring."""
    if x2d.device.type == "cpu":
        return quantized_matmul_reference(x2d, w, bias)
    m, k = x2d.shape
    n = w.shape[0]
    if w.shape != (n, k) or k % 8 or n % 8:
        raise ValueError(f"quantized_matmul: no kernel for x {tuple(x2d.shape)}, "
                         f"w {tuple(w.shape)} (K and N must be multiples of 8)")
    x2d, w = x2d.contiguous(), w.contiguous()
    b = None if bias is None else bias.to(x2d.dtype).contiguous()
    out = torch.empty((m, n), device=x2d.device, dtype=x2d.dtype)
    w_f32 = w.dtype == torch.float32  # the row pass reads a bf16 or an f32 weight
    bf16 = torch.bfloat16
    tensors = (x2d, w, out) if b is None else (x2d, w, out, b)
    _build.check_cuda("quantized_matmul", *tensors,
                      dtypes=(bf16, torch.float32 if w_f32 else bf16, bf16, bf16)[:len(tensors)])
    if m == 0:
        return out
    scratch, (xq, wq, ascale, wscale) = _scratch(m, n, code_pitch(k), x2d.device)
    _build.call("ls_quantized_matmul", x2d.data_ptr(), w.data_ptr(), _build.ptr(b), xq, m, k, n,
                ascale, wq, wscale, out.data_ptr(), int(w_f32), _build.stream(x2d))
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
