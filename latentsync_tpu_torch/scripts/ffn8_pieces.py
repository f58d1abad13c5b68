"""What K10's one-launch kernel waits on, on one NVIDIA GPU: the kernel timed
whole and with pieces taken out.

    python -m latentsync_tpu_torch.scripts.ffn8_pieces [--pieces 0 1 2 4 8 16 6] [--iters 20]

A copy of ``csrc/geglu_i8.cu`` gets ``#if`` hooks (``HOOKS`` below: exact
pieces of its text, so a change to the kernel that moves one of them fails
here and in the CPU tests until the hook follows) and is built once a
variant, all variants at once, with ``nvcc -DLS_PIECES=<bits>`` into
``latentsync_tpu_torch/_build/ffn8_pieces/``, by ``attn_pieces.py``'s
``build``. The bits say what is taken OUT: 1 the exact erf of the GEGLU
epilogue (the gate is used as it stands), 2 the whole GEGLU epilogue (no
hidden tile is written), 4 the products (every wgmma of both projections),
8 the weight copies (the producer signals each stage with no bytes), 16 the
dequantization of x. A variant with pieces out computes nothing meaningful;
variant 0 is the kernel as built, and its output is first held against the
plain version (codes within 1, scales within 2^-6). Both probed shapes are
timed, (131072, 320) and (32768, 640), CUDA events around ``--iters`` calls
after three warm-ups. The first line is the card's name and power limit,
then one JSON line a variant and shape.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import _build, ffn
from .attn_pieces import build, hooked_header, time_ms
from .micro_probe import gpu_line

WORK_DIR = _build.BUILD_DIR / "ffn8_pieces"
DEFAULT_PIECES = (0, 1, 2, 4, 8, 16, 6)
SHAPES = ((131072, 320), (32768, 640))

_ERF = """\
            lo = pack_bf16((v[0] + bv.x) * ls_gemm::gelu_erf(gt[0] + bg.x),
                           (v[1] + bv.y) * ls_gemm::gelu_erf(gt[1] + bg.y));
            hi = pack_bf16((v[2] + bv.x) * ls_gemm::gelu_erf(gt[2] + bg.x),
                           (v[3] + bv.y) * ls_gemm::gelu_erf(gt[3] + bg.y));
"""
_GEGLU = "        for (int j = 0; j < 4; ++j) {\n          uint32_t lo = 0u, hi = 0u;\n"
_UP = ("            wgmma_ss_n64(up, da + wg_step(32 * ks), db + wg_step(32 * ks), kk | ks);\n")
_DOWN = ("            wgmma_ss_n64(acc[pc], dh + wg_step(32 * ks), db + wg_step(32 * ks), 1);\n")
_EXPECT = "          mbar_expect(bar, K::STAGE_BYTES);\n"
_SLOTS = "#pragma unroll\n          for (int slot = 0; slot < K::TPS; ++slot) {\n"
_DEQ_LOADS = ("      for (int j = 0; j < XCH; ++j) {\n        const int i = first + j * bar_threads;\n"
              "        const int grow = rb * K::ROWS + r0 + i / per_row;\n")
_DEQ_STORES = ("      for (int j = 0; j < XCH; ++j) {\n        const int i = first + j * bar_threads;\n"
               "        if (i < 64 * per_row) {\n")


def _hook(bit: int, original: str, replacement: str) -> str:
    return f"#if LS_PIECES & {bit}\n{replacement}#else\n{original}#endif\n"


# (what the hook takes out, the kernel's text, the text with the hook)
HOOKS = [
    ("the GEGLU's erf", _ERF, _hook(1, _ERF, """\
            lo = pack_bf16((v[0] + bv.x) * (gt[0] + bg.x), (v[1] + bv.y) * (gt[1] + bg.y));
            hi = pack_bf16((v[2] + bv.x) * (gt[2] + bg.x), (v[3] + bv.y) * (gt[3] + bg.y));
""")),
    ("the GEGLU epilogue", _GEGLU, _hook(2, _GEGLU, _GEGLU.replace("j < 4", "j < 0"))),
    ("the up-projection's products", _UP, _hook(4, _UP, "")),
    ("the down-projection's products", _DOWN, _hook(4, _DOWN, "")),
    ("the weight copies' bytes", _EXPECT, _hook(8, _EXPECT, "          mbar_expect(bar, 0u);\n")),
    ("the weight copies", _SLOTS, _hook(8, _SLOTS, _SLOTS.replace("slot < K::TPS", "slot < 0"))),
    ("x's loads", _DEQ_LOADS, _hook(16, _DEQ_LOADS, _DEQ_LOADS.replace("j < XCH", "j < 0"))),
    ("x's conversion", _DEQ_STORES, _hook(16, _DEQ_STORES, _DEQ_STORES.replace("j < XCH", "j < 0"))),
]


def hooked_kernel() -> str:
    return hooked_header((_build.SRC_DIR / "geglu_i8.cu").read_text(), HOOKS, "ffn8_pieces")


def run(pieces=DEFAULT_PIECES, iters: int = 20, emit=lambda rec: print(json.dumps(rec),
                                                                       flush=True)) -> bool:
    libs = build(pieces, "geglu_i8.cu", [], hooked_kernel(), "ls_geglu_ffn_int8io",
                 _build._SIGNATURES["ls_geglu_ffn_int8io"], WORK_DIR, "ffn8_pieces")
    gen = torch.Generator().manual_seed(0)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda", torch.bfloat16)

    ok = True
    for m, c in SHAPES:
        xi, xs, w_up, b_up, w_dn, b_dn = (*ffn.quantize_rowwise(r(m, c)), r(8 * c, c, s=c**-0.5),
                                          r(8 * c, s=0.1).float(), r(c, 4 * c, s=(4 * c) ** -0.5),
                                          r(c, s=0.1).float())
        scales = xs.reshape(m).contiguous()
        out = torch.empty((m, c), device="cuda", dtype=torch.int8)
        out_scale = torch.empty((m, 1), device="cuda", dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream

        def call(run_pieces):
            code = run_pieces(xi.data_ptr(), scales.data_ptr(), m, c, w_up.data_ptr(),
                              b_up.data_ptr(), w_dn.data_ptr(), b_dn.data_ptr(), out.data_ptr(),
                              out_scale.data_ptr(), None, stream)
            if code != 0:
                raise RuntimeError(f"ffn8_pieces: CUDA error {code}")

        if 0 in libs:
            call(libs[0])
            ri, rs = ffn.geglu_ffn_int8io_reference(xi, xs, w_up, b_up, w_dn, b_dn)
            torch.cuda.synchronize()
            codes = int((out.int() - ri.int()).abs().max())
            rel = float(((out_scale - rs).abs() / rs).max())
            good = codes <= 1 and rel <= 2.0**-6
            ok &= good
            emit({"shape": [m, c], "pieces_out": 0, "code_diff": codes, "scale_rel": rel,
                  "ok": good})
        for bits, lib in libs.items():
            emit({"shape": [m, c], "pieces_out": bits, "ms": time_ms(lambda: call(lib), iters)})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pieces", type=int, nargs="+", default=list(DEFAULT_PIECES),
                    help="LS_PIECES values: 1 erf, 2 GEGLU, 4 products, 8 weight copies, "
                         "16 dequantization")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ffn8_pieces: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    return 0 if run(args.pieces, args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
