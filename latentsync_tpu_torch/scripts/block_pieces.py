"""What K2's temporal kernel waits on, on one NVIDIA GPU: the kernel timed whole
and with pieces taken out.

    python -m latentsync_tpu_torch.scripts.block_pieces [--pieces 0 1 2 4 8 7] [--iters 20]

A copy of ``csrc/temporal_block.cuh`` gets ``#if`` hooks (``HOOKS`` below:
exact pieces of its text, so a change to the kernel that moves one of them
fails here and in the CPU tests until the hook follows) and is built once a
variant, all variants at once, with ``nvcc -DLS_PIECES=<bits>`` into
``latentsync_tpu_torch/_build/block_pieces/``, by ``attn_pieces.py``'s
``build``. The bits say what is taken
OUT: 1 the LayerNorm pass, 2 the attention (logits, softmax, value product
and the stores of o), 4 the output product's epilogue (at head dim 40; at 80
the template runs it), 8 the copies of weight k-tiles into the ring. A
variant with pieces out computes nothing meaningful; variant 0 is the kernel
as built, and its output is first held against the plain version. Both
served shapes are timed, (4096, 16, 320) and (1024, 16, 640) with 8 heads,
CUDA events around ``--iters`` calls after three warm-ups (at 640 a call is
the kernel and the template's output product). The first line is the card's
name and power limit, then one JSON line a variant and shape.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..ops import _build
from ..ops.attn_block import self_attention_block_reference
from .attn_pieces import build, time_ms
from .micro_probe import gpu_line

WORK_DIR = _build.BUILD_DIR / "block_pieces"
DEFAULT_PIECES = (0, 1, 2, 4, 8, 7)
SHAPES = ((4096, 320), (1024, 640))  # (sequences of 16 frames, C), 8 heads

_COPY_QKV = """\
            cp_async16z(dst + sw128_offset(r, chunk),
                        w + (size_t)(h * D + r - mat * D) * c + (in_k ? col : 0), in_k ? 16 : 0);
"""
_COPY_WO = """\
            cp_async16z(dst + sw128_offset(r, chunk),
                        p.wo + (size_t)row * p.inner + (in_k ? col : 0), in_k ? 16 : 0);
"""
# (what the hook takes out, the kernel's text, the text with the hook)
HOOKS = [
    ("the LayerNorm pass", "  auto ln_tile = [&]() {\n",
     "  auto ln_tile = [&]() {\n#if LS_PIECES & 1\n    if (tid >= 0) return;\n#endif\n"),
    ("the attention", "    constexpr int PC = decltype(pc)::value;\n",
     "    constexpr int PC = decltype(pc)::value;\n#if LS_PIECES & 2\n    if (PC >= 0) return;\n"
     "#endif\n"),
    ("the output product's epilogue", "#pragma unroll\n        for (int q = 0; q < NO / 32; ++q) {",
     "#if LS_PIECES & 4\n        if (false)\n#else\n#pragma unroll\n#endif\n"
     "        for (int q = 0; q < NO / 32; ++q) {"),
    ("the q/k/v weight copies", _COPY_QKV, "#if LS_PIECES & 8\n#else\n" + _COPY_QKV + "#endif\n"),
    ("the output weight copies", _COPY_WO, "#if LS_PIECES & 8\n#else\n" + _COPY_WO + "#endif\n"),
]

HARNESS = r'''
#include "temporal_block.cuh"
extern "C" int ls_block_pieces(const void* x, int batch, int c, int inner, int heads,
                               const float* ln_w, const float* ln_b, float eps, const void* pe,
                               const void* wq, const void* wk, const void* wv, const void* wo,
                               const float* bo, float scale, void* attn, void* out,
                               void* stream) {
  return (int)ls_tblock::temporal_block(x, batch, c, inner, heads, ln_w, ln_b, eps, pe, wq, wk,
                                         wv, wo, bo, scale, attn, out,
                                         static_cast<cudaStream_t>(stream));
}
'''


def run(pieces=DEFAULT_PIECES, iters: int = 20, emit=lambda rec: print(json.dumps(rec),
                                                                       flush=True)) -> bool:
    libs = build(pieces, "temporal_block.cuh", HOOKS, HARNESS, "ls_block_pieces",
                 _build._SIGNATURES["ls_temporal_block"], WORK_DIR, "block_pieces")
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dev, torch.bfloat16)

    ok = True
    for b, c in SHAPES:
        heads = 8
        x, pe = r(b, 16, c), r(16, c)
        ws = [r(c, c, s=c**-0.5) for _ in range(4)]
        ln_w, ln_b, bo = (1 + r(c, s=0.1)).float(), r(c, s=0.1).float(), r(c, s=0.1).float()
        out, attn = torch.empty_like(x), torch.empty((b * 16, c), device=dev, dtype=x.dtype)
        stream = torch.cuda.current_stream().cuda_stream

        def call(run_pieces):
            code = run_pieces(
                x.data_ptr(), b, c, c, heads, ln_w.data_ptr(), ln_b.data_ptr(), 1e-6,
                pe.data_ptr(), *[w.data_ptr() for w in ws], bo.data_ptr(),
                1.0 / math.sqrt(c // heads), attn.data_ptr(), out.data_ptr(), stream)
            if code != 0:
                raise RuntimeError(f"block_pieces: CUDA error {code}")

        if 0 in libs:
            call(libs[0])
            ref = self_attention_block_reference(x, ln_w, ln_b, *ws, bo, heads, temporal=True,
                                                 pe=pe)
            err = float((out.float() - ref.float()).abs().max())
            good = err <= 2.0**-6 * max(1.0, float(ref.float().abs().max()))
            ok &= good
            emit({"shape": [b, 16, c], "pieces_out": 0, "max_abs_err": err, "ok": good})
        for bits, lib in libs.items():
            emit({"shape": [b, 16, c], "pieces_out": bits,
                  "ms": time_ms(lambda: call(lib), iters)})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pieces", type=int, nargs="+", default=list(DEFAULT_PIECES),
                    help="LS_PIECES values: 1 LayerNorm, 2 attention, 4 epilogue, 8 copies")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_pieces: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    return 0 if run(args.pieces, args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
