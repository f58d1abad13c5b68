"""How the plain reference computes its products.

Mode ``f32``: every product in float32, TF32 off (the caller sets the
backend flags). Mode ``control``: the same reference one precision below
what the configuration states, the control that must come out as not
correct: the operands of a product the configuration runs in bfloat16 are
rounded to fp8 e4m3 (one scale a tensor, its absolute maximum at 448);
the operands of a float32 product (whisper) are rounded to bfloat16; an
int8 convolution runs with 4-bit codes (levels -7..7) on the same scales.

An int8 convolution (the configuration's ``LATENTSYNC_INT8=1``) follows
the route the configuration names: symmetric codes with one scale per
output channel of the weight and one per sample of the activation over
(C, H, W), the scale ``max(amax, 1e-8) / 127``, the products of the codes
summed (here in float32 over exact integers, each product below 2^14)
and dequantised with the bias added in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "control"):
            raise ValueError(f"numerics mode {mode!r}: expected f32 or control")
        self.mode = mode

    # the operand rounding of a product the configuration states in bf16 / f32
    def low(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return _fp8(t) if self.mode == "control" else t

    def low32(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return t.to(torch.bfloat16).float() if self.mode == "control" else t

    def linear(self, x, w, b=None, f32_config: bool = False):
        r = self.low32 if f32_config else self.low
        y = r(x) @ r(w).t()
        return y if b is None else y + b.float()

    def matmul(self, a, b, f32_config: bool = False):
        r = self.low32 if f32_config else self.low
        return r(a) @ r(b)

    def conv2d(self, x, w, b=None, stride=1, padding=0, int8: bool = False):
        if int8:
            return self.qconv2d(x, w, b, stride, padding)
        return F.conv2d(self.low(x), self.low(w), None if b is None else b.float(), stride,
                        padding)

    def conv1d(self, x, w, b=None, stride=1, padding=0, f32_config: bool = True):
        r = self.low32 if f32_config else self.low
        return F.conv1d(r(x), r(w), None if b is None else b.float(), stride, padding)

    def qconv2d(self, x, w, b, stride, padding):
        levels = 7.0 if self.mode == "control" else 127.0
        wf, xf = w.float(), x.float()
        ws = wf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-8) / levels
        wq = torch.round(wf / ws).clamp(-levels, levels)
        xs = xf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-8) / levels
        xq = torch.round(xf / xs).clamp(-levels, levels)
        acc = F.conv2d(xq, wq, None, stride, padding)
        y = acc * (ws.reshape(1, -1, 1, 1) * xs)
        return y if b is None else y + b.float()[None, :, None, None]
