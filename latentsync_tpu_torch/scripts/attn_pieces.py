"""What the attention core's tile loops wait on, on one NVIDIA GPU: each loop
timed whole and with pieces taken out.

    python -m latentsync_tpu_torch.scripts.attn_pieces [--pieces 0 1 2 4 8 3 5 14 15]
    python -m latentsync_tpu_torch.scripts.attn_pieces --copies

A copy of ``csrc/attn_core.cuh`` gets ``#if`` hooks (``HOOKS`` below: exact
pieces of its text, so a change to the kernel that moves one of them fails
here and in the CPU tests until the hook follows) and is built once a
variant, all variants at once, with ``nvcc -DLS_PIECES=<bits>`` into
``latentsync_tpu_torch/_build/attn_pieces/``. The bits say what is taken
OUT of the tile loop: 1 the copies of K and V tiles (the first tile's stay),
2 the first product q k^T, 4 the second product p v, 8 the softmax. A variant
with pieces out computes nothing meaningful; variant 0 is the kernel as
built, and its output is first held against a plain attention. Three loops
are timed, CUDA events around ``--iters`` launches after three warm-ups: the
column-split tiling at D = 512 with rounded probabilities (the flash route,
(64, 1024, 1, 512)) and with the three-term split (K12, (64, 1024, 512)), and
the row tiling at D = 128 with the split (K12, (256, 1024, 128): the same
tensors read as four times the batch) as 64-row blocks and as 128-row
blocks. The first line is the card's name and power limit, then one JSON line
a variant.

``hooked_header``, ``build`` and ``time_ms`` serve any kernel's header
(``block_pieces.py`` takes K2's temporal kernel apart with them).

``--copies`` builds and runs ``scripts/copy_bench.cu`` instead: how fast one
block an SM pulls 64 KB tiles from L2 into shared memory with ``cp.async``,
by the number of threads, the tiles in flight and the layout of the
destination (linear, or the 8-row x 16-byte core matrices that scatter a
128-byte line of device memory over eight lines of shared memory), and with
bulk copies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from .micro_probe import gpu_line

HERE = Path(__file__).resolve().parent
WORK_DIR = _build.BUILD_DIR / "attn_pieces"
DEFAULT_PIECES = (0, 1, 2, 4, 8, 3, 5, 14, 15)

# (what the hook takes out, the kernel's text, the text with the hook)
HOOKS = [
    ("the column-split tiling's copies", """\
    load(i + 1, stage ^ 1);  // behind the product, into the stage tile i - 1 has left
    wg_wait();""", """\
#if LS_PIECES & 1
    cp_async_commit();
#else
    load(i + 1, stage ^ 1);
#endif
    wg_wait();"""),
    ("the column-split tiling's first product", """\
    wg_fence();
#pragma unroll
    for (int a = 0; a < W::ATOMS; ++a)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(s, q_desc + wg_step(a * W::Q_ATOM + ks * 32),
                     k_desc + at + wg_step(a * W::T_ATOM + ks * 32), a + ks > 0);
    wg_commit();""", """\
#if LS_PIECES & 2
#pragma unroll
    for (int j = 0; j < WKT / 2; ++j) s[j] = (float)(lane + j + i);
#else
    wg_fence();
#pragma unroll
    for (int a = 0; a < W::ATOMS; ++a)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(s, q_desc + wg_step(a * W::Q_ATOM + ks * 32),
                     k_desc + at + wg_step(a * W::T_ATOM + ks * 32), a + ks > 0);
    wg_commit();
#endif"""),
    ("the column-split tiling's softmax and second product", """\
    softmax_tile<ONLINE>(s, acc, rows, scale_log2, pa);
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < WKT / 16; ++j)
        wgmma_pv<W::DW>(acc, pa[term][j], v_desc + at + wg_step(j * 2048));
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 8
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < WKT / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[term][j][e] = __float_as_uint(s[j * 4 + e]);
#else
    softmax_tile<ONLINE>(s, acc, rows, scale_log2, pa);
#endif
#if LS_PIECES & 4
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += __uint_as_float(pa[0][0][e] ^ pa[TERMS - 1][1][e]);
#else
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < WKT / 16; ++j)
        wgmma_pv<W::DW>(acc, pa[term][j], v_desc + at + wg_step(j * 2048));
    wg_commit();
    wg_wait();
#endif"""),
    ("the row tiling's first product", """\
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_n64(s, aq[kk], ks + wg_step(T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 2
#pragma unroll
    for (int j = 0; j < 32; ++j)
      s[j] = (float)(lane + j) + __uint_as_float(aq[j % KS][j & 3]) + (float)(ks & 1);
#else
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_n64(s, aq[kk], ks + wg_step(T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();
#endif"""),
    ("the row tiling's softmax and copies", """\
    softmax_tile<MODE>(s, acc, rows, scale_log2, pa);
    load(ahead, fill);
    if (MODE == STATS) return;
""", """\
#if LS_PIECES & 8
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < KT / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[term][j][e] = __float_as_uint(s[j * 8 + e + term]);
#else
    softmax_tile<MODE>(s, acc, rows, scale_log2, pa);
#endif
#if LS_PIECES & 1
    cp_async_commit();
#else
    load(ahead, fill);
#endif
    if (MODE == STATS) return;
"""),
    ("the row tiling's second product", """\
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < KT / 16; ++j)
        wgmma_pv<D>(acc, pa[term][j], vs + wg_step(T::v_step(j)));
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 4
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[e] += __uint_as_float(pa[0][0][e] ^ pa[TERMS - 1][3][e]) + (float)(vs & 1);
#else
    wg_fence();
#pragma unroll
    for (int term = 0; term < TERMS; ++term)
#pragma unroll
      for (int j = 0; j < KT / 16; ++j)
        wgmma_pv<D>(acc, pa[term][j], vs + wg_step(T::v_step(j)));
    wg_commit();
    wg_wait();
#endif"""),
]

# loop: 0 the flash route at D = 512, 1 K12 at D = 512, 2 K12 at D = 128 as
# 64-row blocks, 3 as 128-row blocks; q, k, v, o are (batch, seq, 512) tensors
HARNESS = r"""
#include "attn_core.cuh"
extern "C" int pieces_run(const void* q, const void* k, const void* v, void* o, int batch, int seq,
                          int loop, float scale, void* stream) {
  using namespace ls_core;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const Args wide = {qp, kp, vp, 512, 512, 512, op, 512, batch, seq, seq, 1, scale};
  const Args rows = {qp, kp, vp, 128, 128, 128, op, 128, 4 * batch, seq, seq, 1, scale};
  switch (loop) {
    case 0: return (int)run_wide<512, P_ROUNDED>(wide, s);
    case 1: return (int)run_wide<512, P_SPLIT>(wide, s);
    case 2: return (int)launch<128, 1, P_SPLIT>(rows, s);
    case 3: return (int)launch<128, 2, P_SPLIT>(rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""
LOOPS = ("d512_rounded_ms", "d512_split_ms", "d128_split_64rows_ms", "d128_split_128rows_ms")


def hooked_header(text: str, hooks=HOOKS, script: str = "attn_pieces") -> str:
    """`text` (a header of csrc/) with every one of `hooks` in; raises where
    a hook's piece of the kernel is not there exactly once."""
    for what, old, new in hooks:
        if text.count(old) != 1:
            raise ValueError(f"{script}: {what}: the kernel's text has moved "
                             f"({text.count(old)} matches); bring HOOKS up to date")
        text = text.replace(old, new)
    return text


def build(pieces, header: str = "attn_core.cuh", hooks=HOOKS, harness: str = HARNESS,
          entry: str = "pieces_run", argtypes=(*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 3,
                                               ctypes.c_float, ctypes.c_void_p),
          work_dir: Path = WORK_DIR, script: str = "attn_pieces") -> dict:
    """One shared library a variant (an LS_PIECES value), all compiled at
    once from `harness` against csrc/'s headers, `header` with `hooks` in;
    `entry` is bound in each and the libraries returned by variant."""
    work_dir.mkdir(parents=True, exist_ok=True)
    for src in _build.SRC_DIR.glob("*.cuh"):
        text = src.read_text()
        (work_dir / src.name).write_text(
            hooked_header(text, hooks, script) if src.name == header else text)
    (work_dir / "harness.cu").write_text(harness)
    procs = {}
    for n in pieces:
        so = work_dir / f"pieces_{n}.so"
        procs[n] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-DLS_PIECES={n}", "-o", str(so),
             str(work_dir / "harness.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{script}: nvcc failed for LS_PIECES={n}:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        libs[n] = fn
    return libs


def time_ms(call, iters: int, warmup: int = 3) -> float:
    """Mean ms of `call` over `iters` calls after `warmup`, by CUDA events."""
    for _ in range(warmup):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_pieces(pieces, iters: int, emit=lambda rec: print(json.dumps(rec), flush=True)) -> bool:
    libs = build(pieces)
    gen = torch.Generator().manual_seed(0)
    b, s, d = 64, 1024, 512
    q, k, v = (torch.randn((b, s, d), generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    o = torch.empty_like(q)
    scale = d ** -0.5

    def launch(run, loop):
        code = run(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, loop,
                   scale if loop < 2 else 128 ** -0.5, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"attn_pieces: launch refused, CUDA error {code}")

    ok = True
    for n, lib in libs.items():
        rec = {"pieces_out": n}
        if n == 0:  # the kernel as built: right before it is timed
            w = torch.softmax(q[:2].float() @ k[:2].float().transpose(1, 2) * scale, -1)
            for loop, probs in ((0, w.to(torch.bfloat16).float()), (1, w)):
                launch(lib, loop)
                torch.cuda.synchronize()
                ref = probs @ v[:2].float()
                err = float((o[:2].float() - ref).abs().max())
                ok &= err <= 2.0**-6 * max(1.0, float(ref.abs().max()))
                rec[LOOPS[loop].replace("_ms", "_max_abs_err")] = err
        for loop, key in enumerate(LOOPS):
            rec[key] = time_ms(lambda: launch(lib, loop), iters)
        emit(rec)
    return ok


def copy_bench() -> int:
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    exe = WORK_DIR / "copy_bench"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", f"-I{_build.SRC_DIR}",
                    "-o", str(exe), str(HERE / "copy_bench.cu")], check=True)
    return subprocess.run([str(exe)]).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pieces", type=int, nargs="*", default=list(DEFAULT_PIECES),
                    help="variants, each the sum of what it takes out: 1 copies, 2 q k^T, "
                         "4 p v, 8 softmax")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--copies", action="store_true", help="run the copy benchmark instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_pieces: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    if args.copies:
        return copy_bench()
    return 0 if time_pieces(args.pieces, args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
