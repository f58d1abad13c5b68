"""What the flash backward's loops wait on, on one NVIDIA GPU: both launches
timed whole and with pieces taken out, at the three shapes of a train step.

    python -m latentsync_tpu_torch.scripts.bwd_pieces [--pieces 0 1 2 4 8 16 18 30 31]

A copy of ``csrc/flash_attention_bwd.cu`` gets ``#if`` hooks (``HOOKS``:
exact pieces of its text, so a change to the kernel that moves one of them
fails here and in the CPU tests until the hook follows) and is built once a
variant, all at once, with ``nvcc -DLS_PIECES=<bits>`` into
``latentsync_tpu_torch/_build/bwd_pieces/`` (``attn_pieces.build``). The
bits say what is taken OUT of the tile loops of both launches: 1 the
copies of the streamed tiles (the first ones stay), 2 the first two
products (s and dp), 4 the D = 512 kernel's exchange of partial logits
between the two blocks of a cluster (remote stores, their barrier and the
block barrier before the reads), 8 the
exponentials and dS, 16 the output products (dQ, dK, dV). A variant with
pieces out computes nothing meaningful; variant 0 is the kernel as built,
and its gradients are first held equal, bit for bit, to the port's
``flash_attention_bwd``. Each variant is timed by CUDA events around
``--iters`` calls after three warm-ups (both launches, from the residual
forward's o and lse) at (16, 1024, 1, 512), (16, 1024, 8, 40) and
(16, 256, 8, 80). The first line is the card's name and power limit, then
one JSON line a variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from ..ops import _build
from ..ops import attention
from .attn_pieces import build, hooked_header, time_ms
from .micro_probe import gpu_line

WORK_DIR = _build.BUILD_DIR / "bwd_pieces"
SOURCE = _build.SRC_DIR / "flash_attention_bwd.cu"
DEFAULT_PIECES = (0, 1, 2, 4, 8, 16, 18, 30, 31)
SHAPES = [(16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80)]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = (*[_P] * 5, _I, _I, _I, *[_P] * 5, _I, _I, _I, _I, _F, _P)

# (what the hook takes out, the kernel's text, the text with the hook)
HOOKS = [
    ("the row kernel's copies", """\
    load(i + RING - 1, stage == 0 ? RING - 1 : stage - 1);""", """\
#if LS_PIECES & 1
    cp_async_commit();
#else
    load(i + RING - 1, stage == 0 ? RING - 1 : stage - 1);
#endif"""),
    ("the row kernel's first products", """\
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(s, ax[kk], kdesc + wg_step(sb + T::k_step(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(dp, ay[kk], kdesc + wg_step(sb + TILE + T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 2
#pragma unroll
    for (int j = 0; j < 4 * NT; ++j) {
      s[j] = (float)(lane + j + i) + __uint_as_float(ax[j % KS][j & 3]);
      dp[j] = s[j] + __uint_as_float(ay[j % KS][j & 3]);
    }
#else
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(s, ax[kk], kdesc + wg_step(sb + T::k_step(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_n64(dp, ay[kk], kdesc + wg_step(sb + TILE + T::k_step(kk)), kk > 0);
    wg_commit();
    wg_wait();
#endif"""),
    ("the row kernel's exponentials and dS", """\
        p[e] = prob(s[4 * n + e], scale_log2, l[e]);
        ds[e] = p[e] * (dp[4 * n + e] - dl[e]) * a.scale;""", """\
#if LS_PIECES & 8
        p[e] = s[4 * n + e] + l[e];
        ds[e] = dp[4 * n + e] - dl[e];
#else
        p[e] = prob(s[4 * n + e], scale_log2, l[e]);
        ds[e] = p[e] * (dp[4 * n + e] - dl[e]) * a.scale;
#endif"""),
    ("the row kernel's output products", """\
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      const int kb = sb + j * 2 * KCH * 128;
      wgmma_pv<D>(acc, fs[j], ndesc + wg_step(kb));
      if constexpr (DKDV) wgmma_pv<D>(acc2, fp[j], ndesc + wg_step(kb + TILE));
    }
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 16
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] += __uint_as_float(fs[0][e] ^ fs[KT / 16 - 1][e]);
      if constexpr (DKDV) acc2[e] += __uint_as_float(fp[0][e] ^ fp[KT / 16 - 1][e]);
    }
#else
    wg_fence();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      const int kb = sb + j * 2 * KCH * 128;
      wgmma_pv<D>(acc, fs[j], ndesc + wg_step(kb));
      if constexpr (DKDV) wgmma_pv<D>(acc2, fp[j], ndesc + wg_step(kb + TILE));
    }
    wg_commit();
    wg_wait();
#endif"""),
    ("the wide kernel's first product", """\
    wg_fence();
#pragma unroll
    for (int atom = 0; atom < ATOMS; ++atom)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(part, own_desc + wg_step(atom * OWN_ATOM + ks * 32),
                     st_desc + wg_step(sb + atom * ST_ATOM + ks * 32), atom + ks > 0);
    wg_commit();""", """\
#if LS_PIECES & 2
#pragma unroll
    for (int j = 0; j < ST / 2; ++j) part[j] = (float)(lane + j + i) + (float)(own_desc & 1);
#else
    wg_fence();
#pragma unroll
    for (int atom = 0; atom < ATOMS; ++atom)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(part, own_desc + wg_step(atom * OWN_ATOM + ks * 32),
                     st_desc + wg_step(sb + atom * ST_ATOM + ks * 32), atom + ks > 0);
    wg_commit();
#endif"""),
    ("the wide kernel's copies", """\
    load(i + 1, stage ^ 1);  // behind the product, into the stage tile i - 1 has left""", """\
#if LS_PIECES & 1
    cp_async_commit();
#else
    load(i + 1, stage ^ 1);
#endif"""),
    ("the wide kernel's exchange", """\
    const int set = i & 1;""", """\
#if LS_PIECES & 4
    float s[ST / 2], dp[ST / 2];
#pragma unroll
    for (int j = 0; j < ST / 2; ++j) {
      s[j] = part[j];
      dp[j] = part[j] + (float)rank;
    }
#else
    const int set = i & 1;"""),
    ("the end of the wide kernel's exchange", """\
        dp[4 * j + e] = wg == 0 ? o[e] : m[e];
      }
    }""", """\
        dp[4 * j + e] = wg == 0 ? o[e] : m[e];
      }
    }
#endif"""),
    ("the wide kernel's exponentials and dS", """\
        const float p = prob(s[4 * n + e], scale_log2, l);
        v[e] = DKDV && wg == 0 ? p : p * (dp[4 * n + e] - dl) * a.scale;""", """\
#if LS_PIECES & 8
        v[e] = s[4 * n + e] + l + (dp[4 * n + e] - dl);
#else
        const float p = prob(s[4 * n + e], scale_log2, l);
        v[e] = DKDV && wg == 0 ? p : p * (dp[4 * n + e] - dl) * a.scale;
#endif"""),
    ("the wide kernel's output product", """\
    wg_fence();
#pragma unroll
    for (int j = 0; j < ST / 16; ++j) wgmma_pv<N>(acc, fa[j], out_desc + wg_step(sb + j * 2048));
    wg_commit();
    wg_wait();""", """\
#if LS_PIECES & 16
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += __uint_as_float(fa[0][e] ^ fa[ST / 16 - 1][e]);
#else
    wg_fence();
#pragma unroll
    for (int j = 0; j < ST / 16; ++j) wgmma_pv<N>(acc, fa[j], out_desc + wg_step(sb + j * 2048));
    wg_commit();
    wg_wait();
#endif"""),
]


def hooked_source() -> str:
    return hooked_header(SOURCE.read_text(), HOOKS, "bwd_pieces")


def time_pieces(pieces, iters: int, emit=lambda rec: print(json.dumps(rec), flush=True)) -> bool:
    libs = build(pieces, hooks=[], harness=hooked_source(), entry="ls_flash_attention_bwd",
                 argtypes=ARGTYPES, work_dir=WORK_DIR, script="bwd_pieces")
    gen = torch.Generator().manual_seed(0)
    cases = []
    for b, s, h, d in SHAPES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
                       for _ in range(4))
        o, lse = attention.flash_attention_fwd(q, k, v, d**-0.5)
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        cases.append(((b, s, h, d), (q, k, v, o, do, lse, delta), grads))

    def launch(run, shape, ts, grads):
        b, s, h, d = shape
        q, k, v, o, do, lse, delta = ts
        code = run(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   h * d, h * d, h * d, *(g.data_ptr() for g in grads), lse.data_ptr(),
                   delta.data_ptr(), b, s, h, d, d**-0.5, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"bwd_pieces: launch refused, CUDA error {code}")

    ok = True
    for n, lib in libs.items():
        rec = {"pieces_out": n}
        for shape, ts, grads in cases:
            label = "x".join(map(str, shape))
            if n == 0:  # the kernel as built: the port's bits before it is timed
                launch(lib, shape, ts, grads)
                q, k, v, o, do, lse, _ = ts
                want = attention.flash_attention_bwd(q, k, v, do, shape[3]**-0.5, o=o, lse=lse)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(grads, want))
                ok &= same
                rec[f"{label}_equal_to_the_port"] = same
            rec[f"{label}_ms"] = time_ms(lambda: launch(lib, shape, ts, grads), iters)
        emit(rec)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pieces", type=int, nargs="*", default=list(DEFAULT_PIECES),
                    help="variants, each the sum of what it takes out: 1 copies, 2 s and dp, "
                         "4 the exchange (D = 512), 8 exponentials and dS, 16 output products")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_pieces: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    return 0 if time_pieces(args.pieces, args.iters) else 1


if __name__ == "__main__":
    sys.exit(main())
