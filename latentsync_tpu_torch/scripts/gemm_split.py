"""The chains on the GEMM template, launch by launch, on one NVIDIA GPU.

    python -m latentsync_tpu_torch.scripts.gemm_split [--iters 20]

Times K1 (``geglu_ffn`` with its LayerNorm and residual), K9 (``qkv_proj``),
K10 (``geglu_ffn_int8io``, one kernel of its own beside the template) and
K8 (``quantized_matmul``: its quantizing row pass and the template's int8
mode) at the served and probed full-width
shapes, K1, K9 and K8 beside the PyTorch library composition of the same
function (cuBLAS products around separate LayerNorm, GELU and residual
passes for K1, one ``F.linear`` on the concatenated weight for K9,
``torch._int_mm`` on codes quantized before the timing and the
dequantization for K8), which is timed here and used nowhere in the port.
The first line is the card's name and power limit;
then one JSON line a measurement: CUDA events around ``--iters`` launches
after two warm-ups, and ``kernels``, the device time of each kernel of one
further call under ``torch.profiler`` (a chain's row passes and its two
products apart; ``csrc/gemm.cuh`` picks each product's column tile from its
shape, and the kernel's name carries it).

    python -m latentsync_tpu_torch.scripts.gemm_split --tiles

builds a small harness over ``csrc/gemm.cuh`` and ``csrc/attn_core.cuh``
(one nvcc, into ``latentsync_tpu_torch/_build/gemm_tiles/``) and times
K8's product alone at each of its 15 served shapes with each column tile the
template has (64 and 160: the host picks one from the shape), on codes from
the plain row pass, each held bitwise to the plain version first, and K5's
attention core alone at its two served shapes, held to the plain attention.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import _build, ffn, qmm
from ..ops.attention import dot_product_attention_reference
from .micro_probe import gpu_line

FFN_SHAPES = [(65536, 320), (16384, 640), (4096, 1280), (1024, 1280), (131072, 320)]
QKV_SHAPES = [(131072, 320), (32768, 640), (8192, 1280)]
I8_SHAPES = [(131072, 320), (32768, 640)]
QMM_SHAPES = [(65536, 320, 2560), (65536, 320, 320), (65536, 1280, 320), (16384, 640, 5120),
              (4096, 5120, 1280), (1024, 1280, 1280)]
# (M, K, N) of every K8 launch of one int8-dense forward (chip_smoke.py QMM_SHAPES)
QMM_SERVED = [(65536, 320, 2560), (65536, 320, 320), (65536, 1280, 320),
              (16384, 640, 640), (16384, 640, 5120), (16384, 2560, 640),
              (4096, 1280, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
              (1024, 1280, 1280), (1024, 1280, 10240), (1024, 5120, 1280),
              (3200, 384, 320), (3200, 384, 640), (3200, 384, 1280)]
# K5's two served shapes (B, S, C) with 8 heads and 50 audio keys
CROSS_SERVED = [(64, 1024, 320), (64, 256, 640)]
TILES_HARNESS = r"""
#include "attn_core.cuh"
#include "gemm.cuh"
// K8's product alone on codes at pitch kp, with the column tile bn forced
extern "C" int tiles_qmm(const void* xq, const float* ascale, const void* wq, const float* wscale,
                         const void* bias, void* out, int m, int kp, int n, int bn,
                         void* stream) {
  ls_gemm::Args p = {};
  p.a = xq;
  p.lda = kp;
  p.b = wq;
  p.ldb = kp;
  p.c = static_cast<bf16*>(out);
  p.ldc = n;
  p.m = m;
  p.n = n;
  p.k = kp;
  p.nb = 1;
  p.a_scale = ascale;
  p.b_scale = wscale;
  p.bias_bf16 = static_cast<const bf16*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return (int)ls_gemm::launch<64, false, int8_t>(p, s);
    case 160: return (int)ls_gemm::launch<160, false, int8_t>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
// K5's core alone: q and o (b seq, inner), kv (b sk, 2 inner), as cross_attn_block.cu calls it
extern "C" int tiles_cross_core(const void* q, const void* kv, void* o, int b, int seq, int sk,
                                int heads, int d, float scale, void* stream) {
  const bf16* kvp = static_cast<const bf16*>(kv);
  const int inner = heads * d;
  const ls_core::Args a = {static_cast<const bf16*>(q), kvp, kvp + inner, inner, 2 * inner,
                           2 * inner, static_cast<bf16*>(o), inner, b, seq, sk, heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return (int)ls_core::run<40, ls_core::P_NORMALISED>(a, 0, s);
    case 80: return (int)ls_core::run<80, ls_core::P_NORMALISED>(a, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


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
            name = e.name.replace("(anonymous namespace)::", "").replace("ls_gemm::", "")
            name = name.replace("void ", "").split("(")[0]
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
        for m, k, n in QMM_SHAPES:
            x, w, b = r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)
            xq, ascale = qmm.quantize_activations(x)
            xq = xq.to(torch.int8)
            wq, wscale = qmm.quantize_weight(w)

            def library():
                return (torch._int_mm(xq, wq.t()).float() * ascale * wscale).to(x.dtype) + b

            emit({"name": f"qmm_library_int_mm_M{m}_K{k}_N{n}", "ms": cuda_ms(library, iters)})
            emit({"name": f"quantized_matmul_M{m}_K{k}_N{n}",
                  "ms": cuda_ms(lambda: qmm.quantized_matmul(x, w, b), iters),
                  "kernels": kernel_split(lambda: qmm.quantized_matmul(x, w, b))})


def tiles_harness() -> ctypes.CDLL:
    work = _build.BUILD_DIR / "gemm_tiles"
    work.mkdir(parents=True, exist_ok=True)
    (work / "harness.cu").write_text(TILES_HARNESS)
    so = work / "tiles.so"
    proc = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", f"-I{_build.SRC_DIR}", "-o", str(so),
                           str(work / "harness.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"gemm_split: nvcc failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tiles_qmm.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.tiles_cross_core.argtypes = [p] * 3 + [i] * 5 + [ctypes.c_float, p]
    lib.tiles_qmm.restype = lib.tiles_cross_core.restype = i
    return lib


def tiles(iters: int = 20, emit=lambda rec: print(json.dumps(rec), flush=True)) -> bool:
    """K8's product at each column tile and K5's core alone; False if one
    disagrees with its plain version."""
    lib = tiles_harness()
    gen = torch.Generator().manual_seed(1)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda", torch.bfloat16)

    def check(code):
        if code != 0:
            raise RuntimeError(f"gemm_split: launch refused, CUDA error {code}")

    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    with torch.inference_mode():
        for m, k, n in QMM_SERVED:
            x, w, b = r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)
            kp = qmm.code_pitch(k)
            xq, ascale = qmm.quantize_rows_reference(x, kp)
            wq, wscale = qmm.quantize_rows_reference(w, kp)
            want = qmm.quantized_matmul_reference(x, w, b)
            out = torch.empty_like(want)
            rec = {"name": f"qmm_product_M{m}_K{k}_N{n}"}
            for bn in (64, 160):
                def product(bn=bn):
                    check(lib.tiles_qmm(xq.data_ptr(), ascale.data_ptr(), wq.data_ptr(),
                                        wscale.data_ptr(), b.data_ptr(), out.data_ptr(), m, kp,
                                        n, bn, stream))
                product()
                torch.cuda.synchronize()
                rec[f"bn{bn}_bitwise"] = torch.equal(out, want)
                ok &= rec[f"bn{bn}_bitwise"]
                rec[f"bn{bn}_ms"] = cuda_ms(product, iters)
            emit(rec)
        for bt, s, c in CROSS_SERVED:
            heads, sk = 8, 50
            d = c // heads
            q, kv = r(bt * s, c), r(bt * sk, 2 * c)
            o = torch.empty_like(q)

            def core():
                check(lib.tiles_cross_core(q.data_ptr(), kv.data_ptr(), o.data_ptr(), bt, s, sk,
                                           heads, d, d ** -0.5, stream))
            core()
            torch.cuda.synchronize()
            ref = dot_product_attention_reference(
                q.view(bt, s, heads, d), kv[:, :c].reshape(bt, sk, heads, d),
                kv[:, c:].reshape(bt, sk, heads, d)).reshape(bt * s, c)
            err = float((o.float() - ref.float()).abs().max())
            ok &= err <= 2.0**-6 * max(1.0, float(ref.float().abs().max()))
            emit({"name": f"cross_core_B{bt}_S{s}_C{c}", "ms": cuda_ms(core, iters),
                  "max_abs_err": err})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tiles", action="store_true",
                    help="time K8's product at each column tile and K5's core alone instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_split: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    if args.tiles:
        return 0 if tiles(args.iters) else 1
    split(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
