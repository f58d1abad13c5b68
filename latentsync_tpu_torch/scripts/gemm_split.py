"""The chains on the bf16 GEMM template, launch by launch, on one NVIDIA GPU.

    python -m latentsync_tpu_torch.scripts.gemm_split [--iters 20]

Times K1 (``geglu_ffn`` with its LayerNorm and residual), K9 (``qkv_proj``)
and K10 (``geglu_ffn_int8io``) at the served and probed full-width shapes,
K1 and K9 beside the PyTorch library composition of the same function
(cuBLAS products around separate LayerNorm, GELU and residual passes for K1,
one ``F.linear`` on the concatenated weight for K9), which is timed here and
used nowhere in the port. The first line is the card's name and power limit;
then one JSON line a measurement: CUDA events around ``--iters`` launches
after two warm-ups, and ``kernels``, the device time of each kernel of one
further call under ``torch.profiler`` (a chain's row passes and its two
products apart; ``csrc/gemm.cuh`` picks each product's column tile from its
shape, and the kernel's name carries it).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..ops import ffn
from .micro_probe import gpu_line

FFN_SHAPES = [(65536, 320), (16384, 640), (4096, 1280), (1024, 1280), (131072, 320)]
QKV_SHAPES = [(131072, 320), (32768, 640), (8192, 1280)]
I8_SHAPES = [(131072, 320), (32768, 640)]


def cuda_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(fn) -> dict:
    """Device ms of each kernel of one call of `fn`, by (shortened) name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("ls_gemm::", "").replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def split(iters: int = 20, emit=lambda rec: print(json.dumps(rec), flush=True)) -> None:
    gen = torch.Generator().manual_seed(0)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda", torch.bfloat16)

    with torch.inference_mode():
        for m, c in FFN_SHAPES:
            x, w_up, b_up = r(m, c), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1)
            w_dn, b_dn = r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1)
            ln_w, ln_b = 1 + r(c, s=0.1), r(c, s=0.1)

            def library():
                h = F.layer_norm(x, (c,), ln_w, ln_b, 1e-6)
                value, gate = F.linear(h, w_up, b_up).chunk(2, dim=-1)
                return x + F.linear(value * F.gelu(gate), w_dn, b_dn)

            def kernel():
                return ffn.geglu_ffn(x, w_up, b_up, w_dn, b_dn, ln_w, ln_b, residual=True)

            emit({"name": f"geglu_library_composed_M{m}_C{c}", "ms": cuda_ms(library, iters)})
            emit({"name": f"geglu_ffn_M{m}_C{c}", "ms": cuda_ms(kernel, iters),
                  "kernels": kernel_split(kernel)})
        for m, c in QKV_SHAPES:
            x = r(m, c)
            ws = [r(c, c, s=c**-0.5) for _ in range(3)]
            w3 = torch.cat(ws)
            emit({"name": f"qkv_library_linear_M{m}_C{c}",
                  "ms": cuda_ms(lambda: F.linear(x, w3), iters)})
            emit({"name": f"qkv_proj_M{m}_C{c}",
                  "ms": cuda_ms(lambda: ffn.qkv_proj(x, *ws), iters),
                  "kernels": kernel_split(lambda: ffn.qkv_proj(x, *ws))})
        for m, c in I8_SHAPES:
            args = (*ffn.quantize_rowwise(r(m, c)), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1))
            emit({"name": f"geglu_ffn_int8io_M{m}_C{c}",
                  "ms": cuda_ms(lambda: ffn.geglu_ffn_int8io(*args), iters),
                  "kernels": kernel_split(lambda: ffn.geglu_ffn_int8io(*args))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_split: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    split(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
