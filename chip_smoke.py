#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (latentsync_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (the script exits nonzero otherwise,
and without CUDA it exits nonzero before doing anything):

1. print the card's name and power limit; build the CUDA kernels from
   ``latentsync_tpu_torch/csrc`` (one nvcc per source, all at once, sm_90a);
2. hold every kernel against its plain PyTorch version in bf16 at every
   shape the serving path gives it (K8 at the 15 projection shapes of the
   int8-dense configuration, printing whether it is bitwise equal) and, for
   the kernels only the kernel probe runs (K9 fused q/k/v projection, K10
   int8-in/int8-out GEGLU, K11 one-shot attention, K12 streaming attention,
   and the flash route at head dims 40 and 80), at every shape the probe
   gives them at its default 4 windows; time both with CUDA events, and
   beside them the one PyTorch library call that computes the same
   function, where there is one (it is timed here and used nowhere in the
   port); compute each kernel's bound, the least time the card could take
   for the same work, from the bytes of its inputs and outputs and the
   operations of its shapes; the int8 convolution route (im2col +
   ``torch._int_mm``) against its float64 plain version at one UNet shape
   per width and the VAE's largest ones, with equal int32 accumulators;
3. the full-width UNet (LatentSync 1.5 stage 2, random seeded non-zero
   weights) in four configurations of the reference's switches: default,
   fused (``LATENTSYNC_PALLAS_GN=1 LATENTSYNC_FUSED_XATTN=1``), int8
   (``LATENTSYNC_INT8=1``) and int8-dense (``LATENTSYNC_INT8=1
   LATENTSYNC_INT8_DENSE=pallas``): eps is finite, non-zero and depends on
   the audio, each agrees with the default, and each bf16 GPU forward
   agrees with the f32 CPU forward of the same weights and configuration
   on a small input; the median of 5 warm batch-4 forwards of each, the
   GroupNorm shapes of one fused forward and the K8 shapes of one
   int8-dense forward, which must be those phase 2 checked;
4. serve three requests through the port's HTTP server at full width
   (synthetic 576² avatar, 1.2 s and 2.4 s of audio, 20 DDIM steps, CFG
   1.5) in the default configuration, check the output frame counts and
   that every kernel of that path ran (and no kernel of another);
5. serve two requests (1.2 s and 2.4 s) in the fused-kernel
   configuration, with the same checks;
6. serve the same two requests in the int8 and in the int8-dense
   configuration, with the same checks (int8-dense runs K8, the int8
   convolutions and the K3/K4/flash cores, and no K1/K2/K5);
7. run the port's kernel probe (``latentsync_tpu_torch.scripts.micro_probe``)
   in process at full width and its default 4 windows for its modes ffn,
   ffn8, spat and attn: every measurement it prints must be finite, and
   K9, K10 and K11 must have launched there; K12, which nothing in either
   package calls, is driven through its entry point at its three shapes.

The line before the last is a JSON object with each kernel's launches on
its path (``"path"``: the served configuration, ``probe`` or, for K12,
``kernels``), its largest error against the plain version, its time, the
plain version's, the library call's (or null) and its bound with the
resource that sets it; the last line is the device record.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

SEED = 1247
# kernel vs plain version in bf16: |err| <= TOL_REL * max(1, max|plain|),
# about two bf16 ulps at the output's top binade (the kernels keep f32
# where the plain versions round to bf16, and sum in another order)
TOL_REL = 2.0**-6
# full-width UNet, bf16 GPU vs f32 CPU, and fused vs default
# configuration: relative L2 error of eps
UNET_TOL = 5e-2
# int8 configurations: eps against the default's (quantization error; the
# reference's own tests allow 0.10-0.12 mean-relative at toy size), and the
# bf16 GPU forward against the f32 CPU forward of the same configuration
INT8_TOL = 0.25
INT8_CPU_TOL = 0.10
# the reference's switches, by configuration of the same served model
CONFIGS = {
    "default": {},
    "fused": {"LATENTSYNC_PALLAS_GN": "1", "LATENTSYNC_FUSED_XATTN": "1"},
    "int8": {"LATENTSYNC_INT8": "1"},
    "int8-dense": {"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"},
}
SWITCHES = sorted({k for env in CONFIGS.values() for k in env})
# (M, K, N) of every K8 launch of one int8-dense forward at batch 4, 16
# frames, 32² latents: the q/k/v/out, GEGLU up and down projections of the
# spatial and temporal blocks at each level, and the audio context's k/v
QMM_SHAPES = [(65536, 320, 2560), (65536, 320, 320), (65536, 1280, 320),
              (16384, 640, 640), (16384, 640, 5120), (16384, 2560, 640),
              (4096, 1280, 1280), (4096, 1280, 10240), (4096, 5120, 1280),
              (1024, 1280, 1280), (1024, 1280, 10240), (1024, 5120, 1280),
              (3200, 384, 320), (3200, 384, 640), (3200, 384, 1280)]
# (N, C, *spatial), eps, SiLU of every GroupNorm of the served UNet at
# batch 4 (2 windows × CFG 2), 16 frames, 32² latents, by the kernel the
# reference's routing gives it: per-frame transformer/motion norms and
# the cross-frame resnet norms (up-block resnets see concatenated widths)
GN_SINGLE = [((64, 320, 32, 32), 1e-6, False), ((64, 640, 16, 16), 1e-6, False),
             ((64, 1280, 8, 8), 1e-6, False), ((64, 1280, 4, 4), 1e-6, False),
             ((4, 1280, 16, 4, 4), 1e-5, True)]
# the counted kernels (and the int8 convolution route) that each
# configuration's served path must launch; every other counted one must not
# published peaks of one NVIDIA H100 SXM (dense): bytes/s of device memory,
# operations/s by the type of the operands
MEM_RATE = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# where the kernels run that no served configuration launches
PROBE_PATH = {"qkv_proj": "probe", "geglu_ffn_int8io": "probe", "oneshot_attention": "probe",
              "flash_attention": "kernels"}
FLASH_KERNEL_SHAPES = [(64, 1024, 512), (32, 1024, 512), (512, 1024, 128)]
_CORES = {"temporal_attention", "spatial_attention", "dot_product_attention"}
ON_PATH = {
    "default": _CORES | {"geglu_ffn", "self_attention_block"},
    "fused": _CORES | {"geglu_ffn", "self_attention_block", "cross_attention_block",
                       "group_norm_silu", "group_norm_silu_streaming"},
    "int8": _CORES | {"geglu_ffn", "self_attention_block", "conv_acc"},
    "int8-dense": _CORES | {"quantized_matmul", "conv_acc"},
}
GN_STREAMING = [((4, c, 16, 32, 32), 1e-5, True) for c in (960, 640, 320)] \
    + [((4, c, 16, 16, 16), 1e-5, True) for c in (1920, 1280, 960, 640, 320)] \
    + [((4, c, 16, 8, 8), 1e-5, True) for c in (2560, 1920, 1280, 640)] \
    + [((4, 2560, 16, 4, 4), 1e-5, True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def configured(conf: str):
    """The switches of configuration `conf`, and no other, for the duration
    (the port reads them at each call)."""
    old = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(CONFIGS[conf])
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def cuda_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases():
    """One entry per kernel: name, wrapper, plain version, source, the TPU
    kernel it replaces, the library call (or None) and its shapes, each
    (label, make_args, operations, operand type). The served kernels get
    the shapes of the served path: window batch 2 × CFG 2 → B = 4 sequences
    of 16 frames, 32² latents, channels 320/640/1280, 8 heads; the VAE
    encodes up to 64 faces and decodes 32 frames at a time. The probe's
    kernels get the probe's shapes at 4 windows (bf = 128 frames). The
    first shape of each kernel is the one whose times the JSON line
    reports."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import attention, attn_block, ffn, groupnorm as gn
    from latentsync_tpu_torch.ops import qmm
    from latentsync_tpu_torch.ops import temporal_attention as ta

    def ffn_args(m, c):
        def make(r):
            return (r(m, c), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1), r(c, 4 * c, s=(4 * c) ** -0.5),
                    r(c, s=0.1), 1 + r(c, s=0.1), r(c, s=0.1)), {"residual": True}
        return f"M={m} C={c}", make, 24 * m * c * c, "bf16"

    def block_args(b, s, c, temporal):
        def make(r):
            ws = [r(c, c, s=c**-0.5) for _ in range(4)]
            return ((r(b, s, c), 1 + r(c, s=0.1), r(c, s=0.1), *ws, r(c, s=0.1), 8),
                    {"temporal": temporal, "pe": r(s, c) if temporal else None})
        mode = "temporal" if temporal else "spatial"
        return f"{mode} B={b} S={s} C={c}", make, 8 * b * s * c * c + 4 * b * s * s * c, "bf16"

    def attn_args(b, s, hd):
        def make(r):
            return (r(b, s, hd), r(b, s, hd), r(b, s, hd), 8), {}
        return f"B={b} S={s} heads*D={hd}", make, 4 * b * s * s * hd, "bf16"

    def flash_args(b, s=1024, h=1, d=512):
        def make(r):
            return (r(b, s, h, d), r(b, s, h, d), r(b, s, h, d)), {}
        return f"B={b} S={s} H={h} D={d}", make, 4 * b * h * s * s * d, "bf16"

    def cross_args(b, s, c):
        def make(r):
            return ((r(b, s, c), 1 + r(c, s=0.1), r(c, s=0.1), r(b, 50, 384),
                     r(c, c, s=c**-0.5), r(c, 384, s=384**-0.5), r(c, 384, s=384**-0.5),
                     r(c, c, s=c**-0.5), r(c, s=0.1), 8), {})
        ops = 4 * b * s * c * c + 4 * b * 50 * 384 * c + 4 * b * s * 50 * c
        return f"B={b} S={s} C={c} Sk=50 Cc=384", make, ops, "bf16"

    def qmm_args(m, k, n):
        def make(r):
            return (r(m, k), r(n, k, s=k**-0.5), r(n, s=0.1)), {}
        return f"M={m} K={k} N={n}", make, 2 * m * k * n, "int8"

    def gn_args(shape, eps, silu):
        def make(r):
            c = shape[1]
            return (r(*shape) * 2 + 0.5, 1 + r(c, s=0.1), r(c, s=0.1), 32), \
                {"eps": eps, "silu": silu}
        # about ten f32 operations an element (statistics, normalise, SiLU)
        return f"{shape} eps={eps} silu={int(silu)}", make, 10 * math.prod(shape), "f32"

    def qkv_args(m, c):
        def make(r):
            return (r(m, c), *[r(c, c, s=c**-0.5) for _ in range(3)]), {}
        return f"M={m} C={c} inner={c}", make, 6 * m * c * c, "bf16"

    def i8_args(m, c):
        def make(r):
            return (*ffn.quantize_rowwise(r(m, c)), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1).float(),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1).float()), {}
        return f"M={m} C={c}", make, 24 * m * c * c, "bf16"

    def bsd_args(b, s, d):
        def make(r):
            return (r(b, s, d), r(b, s, d), r(b, s, d)), {}
        return f"B={b} S={s} D={d}", make, 4 * b * s * s * d, "bf16"

    # the one PyTorch call for the same function, where there is one
    def sdpa_bshd(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2)).transpose(1, 2)

    def sdpa_rows(q, k, v, heads):
        b, s, hd = q.shape
        q, k, v = (t.reshape(b, s, heads, hd // heads) for t in (q, k, v))
        return sdpa_bshd(q, k, v).reshape(b, s, hd)

    def sdpa_bsd(q, k, v):
        return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]

    def library_gn(x, scale, bias, groups, eps, silu):
        y = F.group_norm(x, groups, scale, bias, eps)
        return F.silu(y) if silu else y

    cat_cache = {}

    def library_qkv(x, wq, wk, wv):
        key = (wq.data_ptr(), wk.data_ptr(), wv.data_ptr())
        if key not in cat_cache:  # concatenated once a shape, in the warm-up
            cat_cache.clear()
            cat_cache[key] = torch.cat([wq, wk, wv])
        return F.linear(x, cat_cache[key]).chunk(3, dim=-1)

    def case(name, wrapper, plain, source, replaces, shapes, library=None):
        return dict(name=name, wrapper=wrapper, plain=plain, source=source, replaces=replaces,
                    shapes=shapes, library=library)

    return [
        case("geglu_ffn", ffn.geglu_ffn, ffn.geglu_ffn_reference,
             "latentsync_tpu_torch/csrc/geglu.cu", "latentsync_tpu/ops/ffn.py:82",
             [ffn_args(65536, 320), ffn_args(16384, 640), ffn_args(4096, 1280),
              ffn_args(1024, 1280)]),
        case("self_attention_block", attn_block.self_attention_block,
             attn_block.self_attention_block_reference,
             "latentsync_tpu_torch/csrc/attn_block.cu", "latentsync_tpu/ops/attn_block.py:76",
             [block_args(4096, 16, 320, True), block_args(1024, 16, 640, True),
              block_args(64, 256, 640, False)]),
        case("temporal_attention", ta.temporal_attention, ta.temporal_attention_reference,
             "latentsync_tpu_torch/csrc/temporal_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:47",
             [attn_args(256, 16, 1280), attn_args(64, 16, 1280),
              # the composed blocks of int8-dense at C = 320 and 640
              attn_args(4096, 16, 320), attn_args(1024, 16, 640)], sdpa_rows),
        case("spatial_attention", ta.spatial_attention, ta.spatial_attention_reference,
             "latentsync_tpu_torch/csrc/spatial_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:173",
             [attn_args(64, 1024, 320), attn_args(64, 64, 1280), attn_args(64, 16, 1280),
              attn_args(64, 256, 640)], sdpa_rows),  # the last: int8-dense's block at C = 640
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(64), flash_args(32),
              # the probe's spatial shapes at 4 windows, 8 heads of D = 40 and 80
              flash_args(128, 1024, 8, 40), flash_args(128, 256, 8, 80)], sdpa_bshd),
        case("cross_attention_block", attn_block.cross_attention_block,
             attn_block.cross_attention_block_reference,
             "latentsync_tpu_torch/csrc/cross_attn_block.cu", "latentsync_tpu/ops/attn_block.py:284",
             [cross_args(64, 1024, 320), cross_args(64, 256, 640)]),
        case("group_norm_silu", gn.group_norm_silu, gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:43",
             [gn_args(*a) for a in GN_SINGLE], library_gn),
        case("group_norm_silu_streaming", gn.group_norm_silu_streaming,
             gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:107",
             [gn_args(*a) for a in GN_STREAMING], library_gn),
        case("quantized_matmul", qmm.quantized_matmul, qmm.quantized_matmul_reference,
             "latentsync_tpu_torch/csrc/qmm.cu", "latentsync_tpu/ops/qmm.py:41",
             [qmm_args(*a) for a in QMM_SHAPES]),
        case("qkv_proj", ffn.qkv_proj, ffn.qkv_proj_reference,
             "latentsync_tpu_torch/csrc/qkv_proj.cu", "latentsync_tpu/ops/ffn.py:269",
             [qkv_args(131072, 320), qkv_args(32768, 640), qkv_args(8192, 1280)], library_qkv),
        case("geglu_ffn_int8io", ffn.geglu_ffn_int8io, ffn.geglu_ffn_int8io_reference,
             "latentsync_tpu_torch/csrc/geglu_i8.cu", "latentsync_tpu/ops/ffn.py:338",
             [i8_args(131072, 320), i8_args(32768, 640)]),
        case("oneshot_attention", attention.oneshot_attention,
             attention.oneshot_attention_reference,
             "latentsync_tpu_torch/csrc/oneshot_attention.cu",
             "latentsync_tpu/ops/attention.py:109",
             [bsd_args(1024, 1024, 40), bsd_args(1024, 256, 80)], sdpa_bsd),
        case("flash_attention", attention.flash_attention, attention.flash_attention_reference,
             "latentsync_tpu_torch/csrc/flash_kernel.cu", "latentsync_tpu/ops/attention.py:145",
             [bsd_args(*a) for a in FLASH_KERNEL_SHAPES], sdpa_bsd),
    ]


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def bound(args, kw, out, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once at the memory rate,
    against `ops` operations at the peak rate for operands of `kind`."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors((args, kw, out)))
    by_bytes, by_ops = nbytes / MEM_RATE * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def compare(name: str, got, ref):
    """(max abs err, tolerance, within tolerance, finite, bitwise equal) of a
    kernel's result against its plain version's."""
    import torch

    if name == "geglu_ffn_int8io":
        # scales within 2^-6 relative, codes within 1 (another summation
        # order can move a value across a rounding boundary), the
        # dequantized output within TOL_REL · max(1, max|plain|) plus one
        # output quantum
        (gi, gs), (ri, rs) = got, ref
        plain = ri.float() * rs
        err = (gi.float() * gs - plain).abs()
        tol = TOL_REL * max(1.0, float(plain.abs().max())) + rs
        good = bool((err <= tol).all()) and float(((gs - rs).abs() / rs).max()) <= TOL_REL \
            and int((gi.int() - ri.int()).abs().max()) <= 1
        return float(err.max()), float(tol.max()), good, bool(torch.isfinite(gs).all()), \
            torch.equal(gi, ri) and torch.equal(gs, rs)
    got, ref = _tensors(got), _tensors(ref)
    err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    tol = TOL_REL * max(1.0, *(float(r.float().abs().max()) for r in ref))
    return err, tol, len(got) == len(ref) and err <= tol, \
        all(bool(torch.isfinite(g).all()) for g in got), \
        all(torch.equal(g, r) for g, r in zip(got, ref))


def check_kernels(device):
    import torch

    gen = torch.Generator().manual_seed(SEED)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(device, torch.bfloat16)

    results, ok = [], True
    for case in kernel_cases():
        name, wrapper, plain, library = (case[k] for k in ("name", "wrapper", "plain", "library"))
        entry = {"name": name, "route": "cuda", "source": case["source"],
                 "replaces": case["replaces"], "launches": 0, "max_abs_err": 0.0, "ms": None,
                 "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
                 "shape": case["shapes"][0][0]}
        for i, (label, make, ops, kind) in enumerate(case["shapes"]):
            args, kw = make(r)
            with configured("fused"):  # the cross block launches its kernel only so
                before = wrapper.launches
                got = wrapper(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                launched = wrapper.launches == before + 1
                err, tol, close, finite, bitwise = compare(name, got, ref)
                bound_ms, bound_by = bound(args, kw, got, ops, kind)
                del ref
                ms = cuda_ms(lambda: wrapper(*args, **kw))
                plain_ms = cuda_ms(lambda: plain(*args, **kw))
                library_ms = None
                if library is not None:
                    library_ms = cuda_ms(lambda: library(*args, *kw.values()))
            good = launched and finite and close
            ok &= good
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if i == 0:
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
            lib = "none" if library_ms is None else f"{library_ms:.4f}"
            log(f"kernel {name:22s} {label:28s} max_abs_err={err:.6g} tol={tol:.6g} "
                f"bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
                f"bound_ms={bound_ms:.4f} ({bound_by}) {'ok' if good else 'FAIL'}")
            del args, kw, got
            torch.cuda.empty_cache()
        results.append(entry)
    return results, ok


def check_int8_conv(device) -> bool:
    """The int8 convolution route (im2col + ``torch._int_mm``) against its
    float64 plain version: equal int32 accumulators, at one UNet shape per
    width (64 frames; conv_in has K = 117, padded) and the VAE's 256² × 128
    convolution and decoder conv_out at the frames of one of the route's
    chunks; then the whole int8 convolution (quantization and dequant
    included) against the float bf16 convolution it replaces."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import qconv

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    ok = True
    # (label, frames, Cin, H, Cout, frames timed)
    cases = [("UNet conv_in", 64, 13, 32, 320, 64), ("UNet 32² C=320", 64, 320, 32, 320, 64),
             ("UNet 16² C=640", 64, 640, 16, 640, 64), ("UNet 8² C=1280", 64, 1280, 8, 1280, 64),
             ("VAE 256² C=128", None, 128, 256, 128, 32),
             ("VAE decoder conv_out", None, 128, 256, 3, 32)]
    for label, n, cin, hw, cout, n_timed in cases:
        n = n or qconv.chunk_frames(hw, hw, cin * 9, cout)
        xq = torch.randint(-127, 128, (n, cin, hw, hw), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=gen, device=device,
                           dtype=torch.int8)
        acc = qconv.conv_acc(xq, wq, (1, 1), (1, 1))
        equal = bool(torch.equal(acc, qconv.conv_acc_reference(xq, wq, (1, 1), (1, 1))))
        del xq, acc
        x = torch.randn((n_timed, cin, hw, hw), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((cout, cin, 3, 3), generator=gen, device=device)
             * (cin * 9) ** -0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn(cout, generator=gen, device=device)).to(torch.bfloat16)
        y = qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1))
        y_float = F.conv2d(x, w, b, 1, 1)
        rel = float((y.float() - y_float.float()).norm() / y_float.float().norm())
        ms = cuda_ms(lambda: qconv.quantized_conv2d(x, w, b, (1, 1), (1, 1)), iters=5)
        float_ms = cuda_ms(lambda: F.conv2d(x, w, b, 1, 1), iters=5)
        ok &= equal
        log(f"int8 conv {label:22s} acc ({n}, {cin}, {hw}, {hw})→{cout}: equal_int32={equal}; "
            f"({n_timed} frames) ms={ms:.4f} float_bf16_ms={float_ms:.4f} "
            f"rel_l2_vs_float={rel:.4g} {'ok' if equal else 'FAIL'}")
        del x, y, y_float
    torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phase 3: the full-width UNet
# ---------------------------------------------------------------------------


def check_unet(unet, device) -> bool:
    import torch

    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel

    gen = torch.Generator().manual_seed(SEED + 1)
    cfg = unet.config
    ok = True
    with torch.inference_mode():
        x = torch.randn((2, cfg.in_channels, 16, 32, 32), generator=gen)
        audio = torch.randn((2, 16, 50, cfg.cross_attention_dim), generator=gen)
        t = torch.tensor([981, 451])
        xb, ab = x.to(device, torch.bfloat16), audio.to(device, torch.bfloat16)
        xs, as_, ts = x[:1, :, :, :8, :8], audio[:1], t[:1]
        eps, small = {}, {}
        for conf in CONFIGS:
            with configured(conf):
                e = unet(xb, t.to(device), ab).float()
                e0 = unet(xb, t.to(device), torch.zeros_like(ab)).float()
                small[conf] = unet(xs.to(device, torch.bfloat16), ts.to(device),
                                   as_.to(device, torch.bfloat16)).float().cpu()
            torch.cuda.synchronize()
            eps[conf] = e
            finite = bool(torch.isfinite(e).all() and torch.isfinite(e0).all())
            mag = float(e.abs().mean())
            dep = float((e - e0).norm() / e.norm())
            good = finite and e.shape == (2, cfg.out_channels, 16, 32, 32) and mag > 1e-2 \
                and dep > 1e-3
            ok &= good
            log(f"unet {conf} eps (2, 4, 16, 32, 32): finite={finite} mean|eps|={mag:.6g} "
                f"|eps(audio)-eps(0)|/|eps|={dep:.6g} {'ok' if good else 'FAIL'}")
            if conf != "default":
                tol = INT8_TOL if conf.startswith("int8") else UNET_TOL
                rel = float((e - eps["default"]).norm() / eps["default"].norm())
                good = rel <= tol
                ok &= good
                log(f"unet {conf} vs default eps (2, 4, 16, 32, 32): rel_l2={rel:.6g} "
                    f"tol={tol} {'ok' if good else 'FAIL'}")
            del e0

        # the same weights in f32 on the CPU run the plain versions
        ref_model = UNet3DConditionModel(cfg)
        ref_model.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
        ref_model.eval()
        for conf, got in small.items():
            t0 = time.time()
            with configured("default" if conf == "fused" else conf):
                ref = ref_model(xs, ts, as_)
            cpu_s = time.time() - t0
            tol = INT8_CPU_TOL if conf.startswith("int8") else UNET_TOL
            rel = float((got - ref).norm() / ref.norm())
            good = bool(torch.isfinite(got).all()) and rel <= tol
            ok &= good
            log(f"unet {conf} bf16 GPU vs f32 CPU (1, 13, 16, 8, 8): rel_l2={rel:.6g} "
                f"tol={tol} cpu_s={cpu_s:.1f} {'ok' if good else 'FAIL'}")
        del ref_model
    return ok


def time_forwards(unet, device) -> bool:
    """Median of 5 warm forwards at the served batch 4 in each
    configuration; the GroupNorm shapes of one fused forward and the K8
    shapes of one int8-dense forward must be the ones phase 2 checked."""
    import statistics

    import torch

    from latentsync_tpu_torch.models import unet3d
    from latentsync_tpu_torch.ops import groupnorm as gn
    from latentsync_tpu_torch.ops import qconv

    gen = torch.Generator().manual_seed(SEED + 4)
    cfg = unet.config
    x = torch.randn((4, cfg.in_channels, 16, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((4, 16, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((4,), 501, device=device)
    seen = {"single": set(), "streaming": set(), None: set()}
    seen_qmm = set()
    auto, qmm_fn = unet3d.group_norm_silu_auto, qconv.quantized_matmul

    def gn_spy(x, scale, bias, groups, eps=1e-5, silu=True):
        route = gn.gn_route(math.prod(x.shape[2:]), x.shape[1])
        seen[route].add((tuple(x.shape), eps, silu))
        return auto(x, scale, bias, groups, eps, silu)

    def qmm_spy(x2d, w, bias=None):
        seen_qmm.add((*x2d.shape, w.shape[0]))
        return qmm_fn(x2d, w, bias)

    with torch.inference_mode():
        for conf in CONFIGS:
            with configured(conf):
                unet3d.group_norm_silu_auto, qconv.quantized_matmul = gn_spy, qmm_spy
                try:
                    unet(x, t, audio)
                finally:
                    unet3d.group_norm_silu_auto, qconv.quantized_matmul = auto, qmm_fn
                if conf != "int8-dense":
                    assert not seen_qmm, "K8 ran outside the int8-dense configuration"
                if conf != "fused":
                    assert not any(seen.values()), "a GroupNorm kernel ran outside 'fused'"
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    unet(x, t, audio)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
            log(f"unet forward batch 4 ({conf}): median_ms={statistics.median(times):.3f} "
                f"all_ms={[round(v, 3) for v in times]}")
            if conf == "fused":
                fused_seen = {k: set(v) for k, v in seen.items()}
                for v in seen.values():
                    v.clear()
    ok = True
    for route, want in (("single", GN_SINGLE), ("streaming", GN_STREAMING), (None, [])):
        good = fused_seen[route] == set(want)
        ok &= good
        log(f"GroupNorm shapes of one fused forward, {route}: {sorted(fused_seen[route])} "
            f"{'ok (as phase 2)' if good else 'FAIL (phase 2 checked ' + str(sorted(want)) + ')'}")
    good = seen_qmm == set(QMM_SHAPES)
    ok &= good
    log(f"K8 shapes (M, K, N) of one int8-dense forward: {sorted(seen_qmm)} "
        f"{'ok (as phase 2)' if good else 'FAIL (phase 2 checked ' + str(sorted(QMM_SHAPES)) + ')'}")
    return ok


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------


def make_avatar(root: str, n_frames: int = 40, size: int = 576, crop_at: int = 32):
    """A synthetic avatar: smooth moving frames, a translation-only align
    matrix, 256² faces as the 2×2 average of the 512² crop, 512 boxes."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import StreamingVideoWriter, write_audio

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.stack([np.stack([128 + 90 * np.sin(xx / 37 + t / 5 + c) * np.cos(yy / 53 - c)
                                 for c in range(3)], -1) for t in range(n_frames)])
    frames = np.clip(frames + rng.normal(0, 4, frames.shape), 0, 255).astype(np.uint8)
    writer = StreamingVideoWriter(os.path.join(root, "avatar.mp4"), fps=25,
                                  frame_hw=(size, size))
    writer.append(frames)
    writer.close()
    crop = frames[:, crop_at:crop_at + 512, crop_at:crop_at + 512].astype(np.float32)
    faces = crop.reshape(n_frames, 256, 2, 256, 2, 3).mean(axis=(2, 4)).round().astype(np.uint8)
    mat = np.array([[1.0, 0.0, -crop_at], [0.0, 1.0, -crop_at]])
    np.savez(os.path.join(root, "avatar.npz"), faces=faces,
             boxes=np.tile([0, 0, 512, 512], (n_frames, 1)),
             affine_matrices=np.repeat(mat[None], n_frames, 0))
    audios = {}
    for sec in (1.2, 2.4):
        path = os.path.join(root, f"speech_{sec}.wav")
        tt = np.arange(int(16000 * sec)) / 16000.0
        wave = 0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt)) \
            + 0.05 * rng.standard_normal(tt.shape)
        write_audio(path, wave.astype(np.float32))
        audios[sec] = path
    return audios


def serve_requests(pipeline, root: str, audios, plan, counters, conf: str):
    """Serve `plan` [(seconds of audio, frames wanted)] in configuration
    `conf` with every count at 0 first; the kernels of that configuration
    (``ON_PATH``) must launch, and every other counted one must not."""
    import torch

    from latentsync_tpu_torch.serving.api import ServingState, make_handler
    from latentsync_tpu_torch.serving.artifacts import AvatarStore
    from latentsync_tpu_torch.utils.media import read_video
    from http.server import ThreadingHTTPServer

    state = ServingState(pipeline, AvatarStore(root), os.path.join(root, "out"))
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    ok, jobs, launches = True, [], {}
    try:
        for fn in counters:
            fn.launches = 0
        with configured(conf):
            jobs = submit_all(base, audios, plan)
            done = wait_all(base, jobs)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        for (job_id, _), (sec, want) in zip(jobs, plan):
            job = done.get(job_id, {"status": "timeout"})
            frames = -1
            if job["status"] == "completed":
                frames = read_video(job["output"], change_fps=False).shape[0]
            good = job["status"] == "completed" and job.get("num_frames") == want == frames
            ok &= good
            log(f"request ({conf}) audio={sec}s status={job['status']} frames={frames} "
                f"(want {want}) latency_s={job.get('latency_s', float('nan')):.3f} "
                f"worker_s={job.get('elapsed', float('nan')):.3f} "
                f"stages={json.dumps(job.get('timings', {}), sort_keys=True)} "
                f"{'ok' if good else 'FAIL ' + str(job.get('error', ''))}")
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
        thread.join(timeout=30)
    for name, n in launches.items():
        want_some = name in ON_PATH[conf]
        good = n > 0 if want_some else n == 0
        ok &= good
        log(f"launches on the served path ({conf}): {name}={n} "
            f"{'ok' if good else 'FAIL'}{'' if want_some else ' (must be 0)'}")
    return launches, ok


def submit_all(base: str, audios, plan):
    jobs = []
    for sec, _ in plan:
        body = json.dumps({"avatar_id": "avatar", "audio_path": audios[sec]}).encode()
        req = urllib.request.Request(base + "/process", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            jobs.append((json.loads(resp.read())["job_id"], time.time()))
    return jobs


def wait_all(base: str, jobs, timeout_s: float = 900):
    done = {}
    deadline = time.time() + timeout_s
    while len(done) < len(jobs) and time.time() < deadline:
        for job_id, t_sub in jobs:
            if job_id in done:
                continue
            with urllib.request.urlopen(f"{base}/jobs/{job_id}", timeout=60) as resp:
                job = json.loads(resp.read())
            if job["status"] in ("completed", "failed"):
                job["latency_s"] = time.time() - t_sub
                done[job_id] = job
        time.sleep(0.2)
    return done


def run_probe(device, counters):
    """Phase 7: the port's kernel probe in process, at full width and its
    default 4 windows, for the modes that run K9 (ffn), K10 (ffn8), K11
    (spat) and the flash route at head dims 40 and 80 (spat, attn); then
    K12 through its entry point at its three shapes. Every count is set to
    0 first and read after."""
    import torch

    from latentsync_tpu_torch.ops import attention
    from latentsync_tpu_torch.scripts import micro_probe

    for fn in counters:
        fn.launches = 0
    probe = micro_probe.Probe(device, w=4, iters=20,
                              emit=lambda rec: log("probe " + json.dumps(rec)))
    for which in ("ffn", "ffn8", "spat", "attn"):
        micro_probe.run(probe, which)
    ok = True
    for rec in probe.results:
        nums = [v for v in rec.values() if isinstance(v, (int, float))]
        good = "ms" in rec and all(math.isfinite(v) and v > 0 for v in nums)
        ok &= good
        if not good:
            log(f"probe measurement {rec.get('name')}: FAIL (not finite and positive)")
    good = len(probe.results) == 31
    ok &= good
    log(f"probe: {len(probe.results)} measurements (want 31) {'ok' if good else 'FAIL'}")
    with torch.inference_mode():
        for b, s, d in FLASH_KERNEL_SHAPES:
            q = probe.randn(b, s, d)
            o = attention.flash_attention(q, q, q)
            torch.cuda.synchronize()
            good = o.shape == q.shape and bool(torch.isfinite(o).all())
            ok &= good
            log(f"flash_attention ({b}, {s}, {d}) through its entry point: "
                f"{'ok' if good else 'FAIL'}")
    launches = {fn.__name__: fn.launches for fn in counters}
    for name, n in launches.items():
        good = n > 0 or name not in PROBE_PATH
        ok &= good
        log(f"launches on the probe path: {name}={n} {'ok' if good else 'FAIL (must launch)'}")
    return launches, ok


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from latentsync_tpu_torch.config import LatentSyncConfig
        from latentsync_tpu_torch.ops import _build, attention, attn_block, ffn, qconv, qmm
        from latentsync_tpu_torch.ops import groupnorm as gn
        from latentsync_tpu_torch.ops import temporal_attention as ta
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.time()
    so = _build.build()
    _build.lib()
    log(f"phase 1: built {so.name} in {time.time() - t0:.1f}s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # the int8 convolution route (conv_acc, torch._int_mm) is counted
    # beside the kernels, though it is no kernel of this repository
    counters = [ffn.geglu_ffn, attn_block.self_attention_block, ta.temporal_attention,
                ta.spatial_attention, attention.dot_product_attention,
                attn_block.cross_attention_block, gn.group_norm_silu,
                gn.group_norm_silu_streaming, qmm.quantized_matmul, qconv.conv_acc,
                ffn.qkv_proj, ffn.geglu_ffn_int8io, attention.oneshot_attention,
                attention.flash_attention]
    ok = True
    phase = "kernels"
    try:
        kernels, good = check_kernels(device)
        ok &= good
        log(f"phase 2 (kernels vs plain versions): {'ok' if good else 'FAIL'}")
        phase = "int8 convolution"
        good = check_int8_conv(device)
        ok &= good
        log(f"phase 2 (int8 convolution route vs plain version): {'ok' if good else 'FAIL'}")

        phase = "unet"
        from latentsync_tpu_torch.audio.features import Audio2Feature
        from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
        from latentsync_tpu_torch.models.vae import AutoencoderKL
        from latentsync_tpu_torch.models.whisper import WhisperEncoder
        from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline
        from latentsync_tpu_torch.utils.convert import init_random_

        cfg = LatentSyncConfig()
        t0 = time.time()
        unet = init_random_(UNet3DConditionModel(cfg.unet), seed=SEED).to(device, torch.bfloat16)
        vae = init_random_(AutoencoderKL(cfg.vae), seed=SEED + 2).to(device, torch.bfloat16)
        whisper = init_random_(WhisperEncoder(cfg.whisper), seed=SEED + 3).to(device)
        n_params = sum(p.numel() for p in unet.parameters())
        log(f"models: unet {n_params / 1e6:.1f}M params, init {time.time() - t0:.1f}s")
        good = check_unet(unet.eval(), device)
        good &= time_forwards(unet, device)
        ok &= good
        log(f"phase 3 (full-width UNet, four configurations): {'ok' if good else 'FAIL'}")

        phase = "serving"
        pipeline = LipsyncPipeline(unet, vae, Audio2Feature(whisper), cfg,
                                   dtype=torch.bfloat16, device=device)
        launches = {}
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            # 1.2 s of audio → 31 frames → 2 windows of 16; 2.4 s → 4 windows
            for number, conf, plan in ((4, "default", [(1.2, 32), (2.4, 64), (1.2, 32)]),
                                       (5, "fused", [(1.2, 32), (2.4, 64)]),
                                       (6, "int8", [(1.2, 32), (2.4, 64)]),
                                       (6, "int8-dense", [(1.2, 32), (2.4, 64)])):
                phase = f"serving ({conf})"
                torch.cuda.reset_peak_memory_stats()
                launches[conf], good = serve_requests(pipeline, root, audios, plan, counters,
                                                      conf)
                ok &= good
                log(f"phase {number} (served path, {conf} configuration, peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB): "
                    f"{'ok' if good else 'FAIL'}")
        phase = "probe"
        probe_launches, good = run_probe(device, counters)
        ok &= good
        log(f"phase 7 (kernel probe at full width: ffn, ffn8, spat, attn; K12's entry point): "
            f"{'ok' if good else 'FAIL'}")
        for k in kernels:
            if k["name"] in PROBE_PATH:
                k["path"], k["launches"] = PROBE_PATH[k["name"]], probe_launches[k["name"]]
                continue
            k["path"] = next(conf for conf in CONFIGS if k["name"] in ON_PATH[conf])
            k["launches"] = launches[k["path"]][k["name"]]
    except Exception:  # noqa: BLE001 — report the phase, then fail
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} raised", file=sys.stderr)
        return 1
    if not ok:
        print("chip_smoke: a check failed (see FAIL above)", file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
