#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (latentsync_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (the script exits nonzero otherwise,
and without CUDA it exits nonzero before doing anything):

1. print the card's name and power limit; build the CUDA kernels from
   ``latentsync_tpu_torch/csrc`` (one nvcc per source, all at once, sm_90a);
2. hold every kernel against its plain PyTorch version in bf16 at every
   shape the serving path gives it (K8 at the 15 projection shapes of the
   int8-dense configuration, where it must be bitwise equal) and, for
   the kernels only the kernel probe runs (K9 fused q/k/v projection, K10
   int8-in/int8-out GEGLU, K11 one-shot attention, K12 streaming attention,
   and the flash route at head dims 40 and 80), at every shape the probe
   gives them at its default 4 windows (K10 up to C = 1280); K2's temporal
   mode and K3 also at F = 8 and 24 frames; K1, K2 and K9 also at one shape
   whose K is no multiple of the GEMM template's 64-deep k-tile and whose M
   and N are ragged; time both with CUDA events, and beside them the one
   PyTorch library call that computes the same function, where there is
   one, or the library composition (K8: ``torch._int_mm`` on codes quantized
   before the timing, and the dequantization; K2 and K5: ``F.layer_norm``,
   ``F.linear``, SDPA, ``F.linear`` and the residual; K1: the cuBLAS
   composition of the GEGLU feed-forward; K10: dequantization, that
   composition and the row quantization), timed here and used nowhere in
   the port; count with ``torch.profiler`` the device kernels one call of
   each kernel's wrapper launches at its first shape, and K2's, K3's, K7's
   and K10's at every shape (K2's temporal mode must be ONE kernel, two at
   C = 640; K3, K7 and K10 one); compute each kernel's bound, the least time the card
   could take for the same work, from the bytes of its inputs and outputs and the
   operations of its shapes, and for the attention kernels the time their
   exponentials alone need on the special-function units
   (``exp_bound_ms``); the int8 convolution route (im2col +
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
   int8-dense forward, which must be those phase 2 checked, with K8's
   launches at each shape and the sum of their bounds; one default forward
   at F = 24 (window batch 1), finite, with K2 and K3 launched as often as
   the route predicts from each block's shape;
4. hold ``finish`` with its decoded chunks as host copies behind CUDA
   events (pinned memory, fetched on a thread) bitwise against the same
   chunks fetched in turn; serve three requests through the port's HTTP
   server at full width (synthetic 576² avatar, 1.2 s and 2.4 s of audio,
   20 DDIM steps, CFG 1.5) in the default configuration, check the output
   frame counts and that every kernel of that path ran (and no kernel of
   another); each request line prints ``overlap_s`` = ``vae_decode`` +
   ``restore`` - ``decode_restore_total`` (the fetch thread's and the
   restoring thread's busy time against the wall time of both);
5. serve two requests (1.2 s and 2.4 s) in the fused-kernel
   configuration, with the same checks;
6. serve the same two requests in the int8 and in the int8-dense
   configuration, with the same checks (int8-dense runs K8, the int8
   convolutions and the K3/K4/flash cores, and no K1/K2/K5);
7. run the port's kernel probe (``latentsync_tpu_torch.scripts.micro_probe``)
   in process at full width and its default 4 windows for its modes ffn,
   ffn8, spat and attn: every measurement it prints must be finite, and
   K9, K10 and K11 must have launched there; K12, which nothing in either
   package calls, is driven through its entry point at its three shapes;
8. onboard a synthetic talking head with the port's ``prepare_video`` on the
   card (the packaged fallback FAN behind the Haar box stage, the served
   VAE's weights from a file: bundle and ``_latents.npz``), hold the card's
   landmarks against the CPU port's on the same 16 frames, time the FAN per
   128 crops (the fallback, and a 2DFAN4-shaped FAN of 4 modules x 256 with
   seeded random weights, the size real weights have), and serve one request
   with no bundle (stage 3, face detection and alignment, on the card) and
   one from the new bundle, which must record no ``device_vae_encode``;
   frame counts, and the default configuration's kernels (and no other)
   launched in this phase.

The line before the last is a JSON object with each kernel's launches on
its path (``"path"``: the served configuration, ``probe`` or, for K12,
``kernels``), its largest error against the plain version, its time, the
plain version's, the library call's (or null) and its bound with the
resource that sets it; the last line is the device record.
"""

from __future__ import annotations

import collections
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
# exponentials a clock an SM (the special-function units of one Hopper SM)
EXP_PER_CLOCK_SM = 16
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


def gpu_query(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return gpu_query("name,power.limit")


def exp_rate() -> float:
    """Exponentials a second the card can do at most: 16 a clock on each SM
    at the highest SM clock ``nvidia-smi`` reports for it."""
    import torch

    mhz = float(gpu_query("clocks.max.sm").split()[0])
    return EXP_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


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
    (label, make_args, operations, operand type) and, for an attention
    kernel, the exponentials of its softmax (one a logit: the least the
    function needs, whatever the kernel spends). The served kernels get
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

    def block_args(b, s, c, temporal, heads=8):
        def make(r):
            ws = [r(c, c, s=c**-0.5) for _ in range(4)]
            return ((r(b, s, c), 1 + r(c, s=0.1), r(c, s=0.1), *ws, r(c, s=0.1), heads),
                    {"temporal": temporal, "pe": r(s, c) if temporal else None})
        mode = "temporal" if temporal else "spatial"
        return f"{mode} B={b} S={s} C={c}", make, 8 * b * s * c * c + 4 * b * s * s * c, "bf16"

    def attn_args(b, s, hd, sliced=False):
        def make(r):
            if sliced:  # q/k/v as column slices of one (rows, 3·inner) projection
                qkv = r(b, s, 3 * hd)
                return (qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], 8), {}
            return (r(b, s, hd), r(b, s, hd), r(b, s, hd), 8), {}
        label = f"B={b} S={s} heads*D={hd}" + (" sliced" if sliced else "")
        return label, make, 4 * b * s * s * hd, "bf16", b * 8 * s * s

    def flash_args(b, s=1024, h=1, d=512):
        def make(r):
            return (r(b, s, h, d), r(b, s, h, d), r(b, s, h, d)), {}
        return f"B={b} S={s} H={h} D={d}", make, 4 * b * h * s * s * d, "bf16", b * h * s * s

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
        return f"B={b} S={s} D={d}", make, 4 * b * s * s * d, "bf16", b * s * s

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
    i8_cache = {}

    def library_qmm(x, w, b):
        """``torch._int_mm`` on codes quantized once a shape (in the warm-up,
        untimed) and its dequantization: the product and epilogue of K8
        without its quantization."""
        # shapes too: a freed shape's memory comes back for the next one
        key = (x.data_ptr(), w.data_ptr(), tuple(x.shape), tuple(w.shape))
        if key not in i8_cache:
            i8_cache.clear()
            xq, ascale = qmm.quantize_activations(x)
            wq, wscale = qmm.quantize_weight(w)
            i8_cache[key] = (xq.to(torch.int8), ascale, wq.t(), wscale)
        xq, ascale, wq_t, wscale = i8_cache[key]
        return (torch._int_mm(xq, wq_t).float() * ascale * wscale).to(x.dtype) + b

    def library_cross(x, ln_w, ln_b, ctx, wq, wk, wv, wo, bo, heads):
        b, s, c = x.shape
        h = F.layer_norm(x, (c,), ln_w, ln_b, 1e-6)
        q = F.linear(h, wq).view(b, s, heads, -1).transpose(1, 2)
        k = F.linear(ctx, wk).view(b, ctx.shape[1], heads, -1).transpose(1, 2)
        v = F.linear(ctx, wv).view(b, ctx.shape[1], heads, -1).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return x + F.linear(o, wo, bo)

    def library_qkv(x, wq, wk, wv):
        key = (wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), tuple(wq.shape))
        if key not in cat_cache:  # concatenated once a shape, in the warm-up
            cat_cache.clear()
            cat_cache[key] = torch.cat([wq, wk, wv])
        return F.linear(x, cat_cache[key]).chunk(3, dim=-1)

    def library_block(x, ln_w, ln_b, wq, wk, wv, wo, bo, heads, temporal, pe):
        """K2: ``F.layer_norm`` (+ pe), ``F.linear`` on the q/k/v weight
        concatenated once a shape, SDPA over each sequence's heads,
        ``F.linear`` with bias and the residual."""
        b, s, c = x.shape
        h = F.layer_norm(x, (c,), ln_w, ln_b, 1e-6)
        if pe is not None:
            h = h + pe
        q, k, v = (t.reshape(b, s, heads, -1).transpose(1, 2)
                   for t in library_qkv(h, wq, wk, wv))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        return x + F.linear(o, wo, bo)

    def library_ffn(x, w_up, b_up, w_dn, b_dn, ln_w, ln_b, residual):
        """K1: the cuBLAS composition (``F.layer_norm``, ``F.linear``, GELU
        gate, ``F.linear``, residual)."""
        h = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, 1e-6)
        value, gate = F.linear(h, w_up, b_up).chunk(2, dim=-1)
        y = F.linear(value * F.gelu(gate), w_dn, b_dn)
        return x + y if residual else y

    def library_ffn_int8io(codes, scales, w_up, b_up, w_dn, b_dn):
        """K10: dequantize, the GEGLU composition, quantize by rows."""
        x = (codes.float() * scales).to(w_up.dtype)
        value, gate = F.linear(x, w_up, b_up.to(x.dtype)).chunk(2, dim=-1)
        return ffn.quantize_rowwise(F.linear(value * F.gelu(gate), w_dn, b_dn.to(x.dtype)))

    def case(name, wrapper, plain, source, replaces, shapes, library=None):
        return dict(name=name, wrapper=wrapper, plain=plain, source=source, replaces=replaces,
                    shapes=shapes, library=library)

    return [
        case("geglu_ffn", ffn.geglu_ffn, ffn.geglu_ffn_reference,
             "latentsync_tpu_torch/csrc/geglu.cu", "latentsync_tpu/ops/ffn.py:82",
             [ffn_args(65536, 320), ffn_args(16384, 640), ffn_args(4096, 1280),
              ffn_args(1024, 1280),
              # K no multiple of the 64-deep k-tile, ragged M and N: the
              # zero-filled last tile and the masks
              ffn_args(200, 72)], library_ffn),
        case("self_attention_block", attn_block.self_attention_block,
             attn_block.self_attention_block_reference,
             "latentsync_tpu_torch/csrc/attn_block.cu", "latentsync_tpu/ops/attn_block.py:76",
             [block_args(4096, 16, 320, True), block_args(1024, 16, 640, True),
              block_args(64, 256, 640, False),
              # M = 208 (a row tile and a part), K = 120 (a short last k-tile)
              block_args(13, 16, 120, True, heads=3),
              # F != 16: sequences padded to 16 tile rows (F = 8) and to 32 (F = 24)
              block_args(4096, 8, 320, True), block_args(4096, 24, 320, True),
              block_args(1024, 8, 640, True), block_args(1024, 24, 640, True)],
             library_block),
        case("temporal_attention", ta.temporal_attention, ta.temporal_attention_reference,
             "latentsync_tpu_torch/csrc/temporal_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:47",
             [attn_args(256, 16, 1280), attn_args(64, 16, 1280),
              # the composed blocks of int8-dense at C = 320 and 640
              attn_args(4096, 16, 320), attn_args(1024, 16, 640),
              # q/k/v pitched inside one fused projection (head dim 40)
              attn_args(64, 16, 320, sliced=True),
              # F != 16: one row tile, keys past F masked (8); two row tiles (24)
              attn_args(256, 8, 1280), attn_args(256, 24, 1280)], sdpa_rows),
        case("spatial_attention", ta.spatial_attention, ta.spatial_attention_reference,
             "latentsync_tpu_torch/csrc/spatial_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:173",
             [attn_args(64, 1024, 320), attn_args(64, 64, 1280), attn_args(64, 16, 1280),
              attn_args(64, 256, 640),  # int8-dense's block at C = 640
              # a length that is no multiple of the key tile, and K2's spatial
              # mode: q/k/v pitched inside one fused projection
              attn_args(2, 100, 320), attn_args(64, 256, 640, sliced=True)], sdpa_rows),
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(64), flash_args(32),
              # the probe's spatial shapes at 4 windows, 8 heads of D = 40 and 80
              flash_args(128, 1024, 8, 40), flash_args(128, 256, 8, 80)], sdpa_bshd),
        case("cross_attention_block", attn_block.cross_attention_block,
             attn_block.cross_attention_block_reference,
             "latentsync_tpu_torch/csrc/cross_attn_block.cu", "latentsync_tpu/ops/attn_block.py:284",
             [cross_args(64, 1024, 320), cross_args(64, 256, 640),
              cross_args(3, 300, 640)],  # a query length off the core's 128-row block
             library_cross),
        case("group_norm_silu", gn.group_norm_silu, gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:43",
             [gn_args(*a) for a in GN_SINGLE], library_gn),
        case("group_norm_silu_streaming", gn.group_norm_silu_streaming,
             gn.group_norm_silu_reference,
             "latentsync_tpu_torch/csrc/groupnorm.cu", "latentsync_tpu/ops/groupnorm.py:107",
             [gn_args(*a) for a in GN_STREAMING]
             # a spatial size that is no multiple of 8: element loads
             + [gn_args((3, 64, 5, 7), 1e-5, False)], library_gn),
        case("quantized_matmul", qmm.quantized_matmul, qmm.quantized_matmul_reference,
             "latentsync_tpu_torch/csrc/qmm.cu", "latentsync_tpu/ops/qmm.py:41",
             [qmm_args(*a) for a in QMM_SHAPES], library_qmm),
        case("qkv_proj", ffn.qkv_proj, ffn.qkv_proj_reference,
             "latentsync_tpu_torch/csrc/qkv_proj.cu", "latentsync_tpu/ops/ffn.py:269",
             [qkv_args(131072, 320), qkv_args(32768, 640), qkv_args(8192, 1280),
              qkv_args(200, 72)],  # ragged M, N and last k-tile
             library_qkv),
        case("geglu_ffn_int8io", ffn.geglu_ffn_int8io, ffn.geglu_ffn_int8io_reference,
             "latentsync_tpu_torch/csrc/geglu_i8.cu", "latentsync_tpu/ops/ffn.py:338",
             [i8_args(131072, 320), i8_args(32768, 640),
              i8_args(200, 72),  # ragged M, N and last k-tile
              i8_args(300, 400),  # the column split with a ragged last piece
              # the probe's third level: column groups across blocks, the row pass
              i8_args(8192, 1280)],
             library_ffn_int8io),
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


# device kernels of the port that one call must launch, by shape label (no
# torch kernel counted): K2's temporal mode is one kernel (two at C = 640,
# where the output product runs on the GEMM template), K3 and K7 one, K10
# one (two at C = 1280: the column-split kernel and its row pass)
KERNELS_A_CALL = {
    "self_attention_block": lambda label: (2 if "C=640" in label else 1)
    if label.startswith("temporal") else 4,
    "temporal_attention": lambda label: 1,
    "group_norm_silu_streaming": lambda label: 1,
    "geglu_ffn_int8io": lambda label: 2 if label.endswith("C=1280") else 1,
}


def kernels_a_call(fn, attempts: int = 8):
    """(the port's device kernels, torch's device kernels) that one call of
    `fn` launches, from ``torch.profiler``: torch's are named ``at::...``
    (the wrapper's casts of parameters), the port's are not. A call launches
    at least one kernel, so a trace with none lost its events (it happens
    on the card now and then, sometimes for several traces in a row): it is
    taken again, up to `attempts` times, each after a longer pause."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = []
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.25 * attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    port = [n for n in names if "at::" not in n]
    return len(port), len(names) - len(port)


def check_kernels(device):
    import torch

    gen = torch.Generator().manual_seed(SEED)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(device, torch.bfloat16)

    results, ok = [], True
    exps_per_s = exp_rate()
    for case in kernel_cases():
        name, wrapper, plain, library = (case[k] for k in ("name", "wrapper", "plain", "library"))
        entry = {"name": name, "route": "cuda", "source": case["source"],
                 "replaces": case["replaces"], "launches": 0, "max_abs_err": 0.0, "ms": None,
                 "plain_ms": None, "bound_ms": None, "bound_by": None, "library_ms": None,
                 "shape": case["shapes"][0][0]}
        for i, (label, make, ops, kind, *exps) in enumerate(case["shapes"]):
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
            # K8 must equal its plain version bit for bit
            good = launched and finite and close and (bitwise or name != "quantized_matmul")
            calls = ""
            if i == 0 or name in KERNELS_A_CALL:
                with configured("fused"):
                    port_k, torch_k = kernels_a_call(lambda: wrapper(*args, **kw))
                if i == 0:
                    entry.update(kernels_a_call=port_k, torch_kernels_a_call=torch_k)
                good &= name not in KERNELS_A_CALL or port_k == KERNELS_A_CALL[name](label)
                calls = f" kernels_a_call={port_k} (+{torch_k} torch)"
            ok &= good
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            exp_bound = f" exp_bound_ms={exps[0] / exps_per_s * 1e3:.4f}" if exps else ""
            if i == 0:
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
                if exps:
                    entry["exp_bound_ms"] = exps[0] / exps_per_s * 1e3
            lib = "none" if library_ms is None else f"{library_ms:.4f}"
            log(f"kernel {name:22s} {label:28s} max_abs_err={err:.6g} tol={tol:.6g} "
                f"bitwise={bitwise} ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
                f"bound_ms={bound_ms:.4f} ({bound_by}){exp_bound}{calls} "
                f"{'ok' if good else 'FAIL'}")
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
    seen_qmm = collections.Counter()  # launches by (M, K, N)
    auto, qmm_fn = unet3d.group_norm_silu_auto, qconv.quantized_matmul

    def gn_spy(x, scale, bias, groups, eps=1e-5, silu=True):
        route = gn.gn_route(math.prod(x.shape[2:]), x.shape[1])
        seen[route].add((tuple(x.shape), eps, silu))
        return auto(x, scale, bias, groups, eps, silu)

    def qmm_spy(x2d, w, bias=None):
        seen_qmm[(*x2d.shape, w.shape[0])] += 1
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
    good = set(seen_qmm) == set(QMM_SHAPES)
    ok &= good
    log(f"K8 shapes (M, K, N) of one int8-dense forward: {sorted(seen_qmm)} "
        f"{'ok (as phase 2)' if good else 'FAIL (phase 2 checked ' + str(sorted(QMM_SHAPES)) + ')'}")
    for shape, n in sorted(seen_qmm.items()):
        log(f"K8 launches of one int8-dense forward at (M, K, N) = {shape}: {n}, "
            f"bound {n} x {qmm_bound_ms(*shape):.4f} ms")
    log(f"K8 in one int8-dense forward: {sum(seen_qmm.values())} launches, bound sum "
        f"{sum(n * qmm_bound_ms(*shape) for shape, n in seen_qmm.items()):.4f} ms")
    return ok


def check_unet_frames(unet, device, frames: int = 24) -> bool:
    """One default forward at F = `frames` (window batch 1 × CFG 2): eps
    finite and of the expected shape, and K2 and K3 launched as often as
    the route predicts from each attention block's input shape (forward
    pre-hooks on the transformer blocks: a temporal block's sequences go to
    K2 where ``fused_route`` takes them, else to K3; a spatial block's to K2
    where it takes them). Counts are set to 0 just before the forward and
    read just after."""
    import torch

    from latentsync_tpu_torch.models import unet3d
    from latentsync_tpu_torch.ops import attn_block
    from latentsync_tpu_torch.ops import temporal_attention as ta

    want = collections.Counter()

    def temporal_hook(mod, inp):
        _, f, c = inp[0].shape
        for _ in mod.attention_blocks:
            want["K2" if attn_block.fused_route(f, c, c, True, mod.heads) else "K3"] += 1

    def spatial_hook(mod, inp):
        _, s_len, c = inp[0].shape
        if attn_block.fused_route(s_len, c, mod.attn1.weights()[0].shape[0], False, mod.heads):
            want["K2"] += 1

    hooks = [m.register_forward_pre_hook(temporal_hook) for m in unet.modules()
             if isinstance(m, unet3d.TemporalTransformerBlock)]
    hooks += [m.register_forward_pre_hook(spatial_hook) for m in unet.modules()
              if isinstance(m, unet3d.BasicTransformerBlock)]
    gen = torch.Generator().manual_seed(SEED + 6)
    cfg = unet.config
    x = torch.randn((2, cfg.in_channels, frames, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((2, frames, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((2,), 501, device=device)
    try:
        with torch.inference_mode(), configured("default"):
            attn_block.self_attention_block.launches = ta.temporal_attention.launches = 0
            eps = unet(x, t, audio)
            torch.cuda.synchronize()
            got = {"K2": attn_block.self_attention_block.launches,
                   "K3": ta.temporal_attention.launches}
    finally:
        for h in hooks:
            h.remove()
    finite = bool(torch.isfinite(eps.float()).all())
    good = finite and tuple(eps.shape) == (2, cfg.out_channels, frames, 32, 32) \
        and got == dict(want) and want["K2"] > 0 and want["K3"] > 0
    log(f"unet default eps (2, 4, {frames}, 32, 32) at F = {frames}: finite={finite} "
        f"launches K2={got['K2']} K3={got['K3']} (route predicts K2={want['K2']} "
        f"K3={want['K3']}) {'ok' if good else 'FAIL'}")
    return good


def qmm_bound_ms(m: int, k: int, n: int) -> float:
    """K8's bound at one shape: x, w and the output moved once (2MK + 2NK +
    2MN bytes) against 2MNK int8 operations."""
    return max((2 * m * k + 2 * n * k + 2 * m * n) / MEM_RATE,
               2 * m * n * k / PEAK_OPS["int8"]) * 1e3


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------


def make_avatar(root: str, n_frames: int = 40, size: int = 576, crop_at: int = 32):
    """A synthetic avatar: smooth moving frames, a translation-only align
    matrix, 256² faces as the 2×2 average of the 512² crop, 512 boxes."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import StreamingVideoWriter

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
    return {sec: write_speech(os.path.join(root, f"speech_{sec}.wav"), sec) for sec in (1.2, 2.4)}


def check_finish_fetch(pipeline, device) -> bool:
    """``finish`` on the card: decoded chunks handed over as host copies
    behind CUDA events (as ``denoise_decode_chunks`` hands them) give bitwise
    the frames of the same chunks fetched in turn with ``.cpu()``. A small
    synthetic clip that wraps past its end, the writer replaced by one that
    keeps the frames."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.pipelines import lipsync

    kept = []

    class KeepFrames:
        def __init__(self, path, fps, frame_hw, audio_path=None):
            self.path, self.busy_s = path, 0.0

        def append(self, frames):
            kept.append(np.array(frames, copy=True))

        def close(self):
            return self.path

        def abort(self):
            pass

    rng = np.random.default_rng(SEED)
    nf, nw, res, hw, n_src = 16, 4, 256, 320, 40
    total = nf * nw
    frames = rng.integers(0, 256, (n_src, hw, hw, 3), dtype=np.uint8)
    gen = torch.Generator(device=device).manual_seed(SEED)
    chunks = [torch.randint(0, 256, (2 * nf, res, res, 3), generator=gen, device=device,
                            dtype=torch.uint8) for _ in range(nw // 2)]
    mat = np.array([[1.0, 0.0, -32.0], [0.0, 1.0, -32.0]])
    masks = (rng.random((total, res, res, 1)) > 0.5).astype(np.float32)

    def run(as_host_copies: bool):
        state = lipsync.JobState(
            latents0=None, mask_w=None, masked_lat_w=None, ref_lat_w=None, audio_w=None,
            frames=frames.copy(), boxes=[[0, 0, res, res]] * total, matrices=[mat] * total,
            masks=masks, pixel_values=np.zeros((total, res, res, 3), np.float32),
            audio_samples=np.zeros(16000 * 3, np.float32), num_frames=nf, num_windows=nw,
            video_fps=25, audio_sample_rate=16000, lat_hw=32, processor=None, timings={},
            start_time=time.time())
        pieces = [(slice(i * 2 * nf, (i + 1) * 2 * nf),
                   lipsync._to_host(c) if as_host_copies else c.cpu())
                  for i, c in enumerate(chunks)]
        writer_cls, lipsync.StreamingVideoWriter = lipsync.StreamingVideoWriter, KeepFrames
        kept.clear()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                out = pipeline.finish(state, None, os.path.join(tmp, "x.mp4"), pieces=pieces)
        finally:
            lipsync.StreamingVideoWriter = writer_cls
        return np.concatenate(kept), out.elapsed, pieces

    got, timings, pieces = run(True)
    want, _, _ = run(False)
    good = all(isinstance(p, lipsync.HostCopy) and p.host.is_pinned() for _, p in pieces) \
        and got.shape == (total, hw, hw, 3) and bool(np.array_equal(got, want)) \
        and not np.array_equal(got, frames[np.arange(total) % n_src]) \
        and not any(t.name == "finish-fetch" for t in threading.enumerate())
    log(f"finish with host copies behind events vs chunks fetched in turn: bitwise="
        f"{bool(np.array_equal(got, want))} vae_decode={timings['vae_decode']:.4f}s "
        f"restore={timings['restore']:.4f}s {'ok' if good else 'FAIL'}")
    return good


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
            tm = job.get("timings", {})
            overlap = tm.get("vae_decode", float("nan")) + tm.get("restore", float("nan")) \
                - tm.get("decode_restore_total", float("nan"))
            log(f"request ({conf}) audio={sec}s status={job['status']} frames={frames} "
                f"(want {want}) latency_s={job.get('latency_s', float('nan')):.3f} "
                f"worker_s={job.get('elapsed', float('nan')):.3f} overlap_s={overlap:.3f} "
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


# card vs CPU landmarks of the same frames (the FAN's f32 convolutions with
# TF32 off on the card): most points agree to float rounding; a point whose
# two neighbouring heatmap values are nearly equal may flip its ±0.25 px
# refinement, which moves it by at most half a heatmap pixel (2 crop px at
# a 256² crop, scaled to the frame)
LM_CLOSE_PX, LM_CLOSE_SHARE, LM_MAX_PX = 0.05, 0.95, 4.0


def make_face_video(path: str, n_frames: int = 48, size: int = 320):
    """A synthetic talking head drawn with OpenCV (RGB): a skin-toned head
    on a plain background, brows, eyes, a nose and a mouth that opens and
    closes, moving a little; written at 25 fps. Returns the frames."""
    import cv2
    import numpy as np

    from latentsync_tpu_torch.utils.media import StreamingVideoWriter

    rng = np.random.default_rng(SEED)
    frames = []
    for t in range(n_frames):
        img = np.zeros((size, size, 3), np.uint8)
        img[:] = (70, 90, 110)
        cx = size // 2 + int(round(6 * math.sin(t / 7)))
        cy = int(size * 0.45) + int(round(4 * math.cos(t / 9)))
        cv2.ellipse(img, (cx, cy), (70, 92), 0, 0, 360, (224, 180, 150), -1)
        for side in (-1, 1):
            cv2.line(img, (cx + side * 42, cy - 36), (cx + side * 14, cy - 40), (60, 40, 30), 4)
            cv2.ellipse(img, (cx + side * 28, cy - 18), (12, 6), 0, 0, 360, (250, 250, 250), -1)
            cv2.circle(img, (cx + side * 28, cy - 18), 4, (40, 30, 20), -1)
        cv2.line(img, (cx, cy - 10), (cx - 5, cy + 18), (170, 120, 100), 3)
        opening = 3 + int(round(10 * abs(math.sin(t / 3))))
        cv2.ellipse(img, (cx, cy + 46), (26, opening), 0, 0, 360, (120, 40, 50), -1)
        noisy = img.astype(np.float32) + rng.normal(0, 3, img.shape)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
    frames = np.stack(frames)
    writer = StreamingVideoWriter(path, fps=25, frame_hw=(size, size))
    writer.append(frames)
    writer.close()
    return frames


def write_speech(path: str, sec: float) -> str:
    """`sec` seconds of a 220 Hz tone, amplitude-modulated at 3 Hz, with
    seeded noise: a 16 kHz WAV."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_audio

    rng = np.random.default_rng(SEED)
    tt = np.arange(int(16000 * sec)) / 16000.0
    wave = 0.3 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 3 * tt)) \
        + 0.05 * rng.standard_normal(tt.shape)
    write_audio(path, wave.astype(np.float32))
    return path


def landmark_agreement(a, b):
    """(largest distance in px, share of points within LM_CLOSE_PX)."""
    import numpy as np

    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64), axis=-1)
    return float(d.max()), float((d <= LM_CLOSE_PX).mean())


def check_onboarding(pipeline, vae, device, counters):
    """Phase 8: onboard a synthetic talking head with the port's
    ``prepare_video`` on the card (the packaged fallback FAN behind the Haar
    box stage, the served VAE's weights from a file), hold the card's
    landmarks against the CPU port's on the same frames, time the FAN, then
    serve one request with no bundle (stage 3 on the card) and one from the
    new bundle with its ``_latents.npz`` (no VAE encode). Counts are set to
    0 before the onboarding and read after the two requests: the default
    configuration's kernels must launch and no other."""
    import contextlib
    import io

    import numpy as np
    import torch

    from latentsync_tpu_torch.models.face_detection import (FAN2D, FANLandmarkDetector,
                                                            HaarBoxDetector)
    from latentsync_tpu_torch.scripts import prepare_video
    from latentsync_tpu_torch.utils.convert import init_random_, load_state_dict_file
    from latentsync_tpu_torch.utils.image_processor import FALLBACK_FAN_PATH
    from latentsync_tpu_torch.utils.media import read_video

    ok = True
    saved = {k: os.environ.pop(k, None) for k in (
        "LATENTSYNC_FAN_CKPT", "LATENTSYNC_S3FD_CKPT", "LATENTSYNC_NO_FALLBACK_FAN")}
    try:
        with tempfile.TemporaryDirectory() as root, configured("default"):
            n_frames = 48
            video = os.path.join(root, "talker.mp4")
            make_face_video(video, n_frames)
            speech = write_speech(os.path.join(root, "speech.wav"), 1.2)
            vae_path = os.path.join(root, "vae.pt")
            torch.save(vae.state_dict(), vae_path)
            for fn in counters:
                fn.launches = 0
            out = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out):
                rc = prepare_video.main(["--video", video, "--avatar-id", "talker", "--store",
                                         os.path.join(root, "store"), "--vae-ckpt", vae_path,
                                         "--device", "cuda"])
            record = json.loads(out.getvalue().strip().splitlines()[-1])
            with np.load(record["bundle"]) as bundle:
                faces, mats = bundle["faces"], bundle["affine_matrices"]
            good = rc == 0 and faces.shape == (n_frames, 256, 256, 3) \
                and os.path.isfile(record["latents"]) and bool(np.isfinite(mats).all())
            ok &= good
            log(f"onboarding prepare_video on cuda: {n_frames} frames in "
                f"{time.time() - t0:.3f}s (faces {record['faces_s']:.3f}s, latents "
                f"{record['latents_s']:.3f}s) bundle faces {faces.shape} "
                f"{'ok' if good else 'FAIL'}")

            # the card's landmarks against the CPU port's on the same frames
            clip = list(read_video(video, change_fps=True, fps=25)[:16])
            sd = load_state_dict_file(FALLBACK_FAN_PATH)
            lm = {dev: FANLandmarkDetector(sd, face_detector=HaarBoxDetector(), device=dev)
                  .detect_batch(clip) for dev in (device, "cpu")}
            worst, share = landmark_agreement(lm[device], lm["cpu"])
            good = bool(np.isfinite(lm[device]).all()) and worst <= LM_MAX_PX \
                and share >= LM_CLOSE_SHARE
            ok &= good
            log(f"landmarks card vs CPU, 16 frames x 68 points: max {worst:.4g} px, "
                f"{100 * share:.2f}% within {LM_CLOSE_PX} px {'ok' if good else 'FAIL'}")

            # the FAN forward (and decode, and the coordinates' fetch) per 128
            # crops: the fallback, and the size of real 2DFAN4 weights
            fan4 = init_random_(FAN2D(4, 256), seed=SEED).state_dict()
            crops = np.repeat(faces, 3, axis=0)[:128]
            for label, state in (("fallback, 1 module x 128", sd),
                                 ("2DFAN4 shape, 4 modules x 256, random weights", fan4)):
                det = FANLandmarkDetector(state, device=device)
                det.landmarks(crops)
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det.landmarks(crops)
                    times.append((time.perf_counter() - t0) * 1e3)
                good = bool(np.isfinite(det.landmarks(crops[:4])).all())
                ok &= good
                log(f"FAN forward per 128 crops ({label}): median_ms={sorted(times)[1]:.3f} "
                    f"all_ms={[round(v, 3) for v in times]} {'ok' if good else 'FAIL'}")
                del det

            # one request with no bundle: stage 3 on the card
            res = pipeline(video, speech, os.path.join(root, "nobundle.mp4"))
            frames = read_video(res.video_path, change_fps=False).shape[0]
            tm = res.elapsed
            good = res.num_frames == frames == 32 and "device_vae_encode" in tm
            ok &= good
            log(f"request without a bundle: frames={frames} (want 32) faces_s={tm['faces']:.3f} "
                f"({tm['faces'] / (n_frames / 25):.3f} s per second of video) "
                f"stages={json.dumps(tm, sort_keys=True)} {'ok' if good else 'FAIL'}")

            # one request from the new bundle and its latents: no VAE encode
            res = pipeline(record["video"], speech, os.path.join(root, "bundle.mp4"),
                           data_path=record["bundle"])
            frames = read_video(res.video_path, change_fps=False).shape[0]
            tm = res.elapsed
            good = res.num_frames == frames == 32 and "device_vae_encode" not in tm \
                and "device_denoise" in tm
            ok &= good
            log(f"request from the onboarded bundle and its _latents.npz: frames={frames} "
                f"(want 32) device_vae_encode recorded={'device_vae_encode' in tm} "
                f"stages={json.dumps(tm, sort_keys=True)} {'ok' if good else 'FAIL'}")
            torch.cuda.synchronize()
            for fn in counters:
                want_some = fn.__name__ in ON_PATH["default"]
                good = fn.launches > 0 if want_some else fn.launches == 0
                ok &= good
                log(f"launches on the onboarding path: {fn.__name__}={fn.launches} "
                    f"{'ok' if good else 'FAIL'}{'' if want_some else ' (must be 0)'}")
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    return ok


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
    good = len(probe.results) == 33
    ok &= good
    log(f"probe: {len(probe.results)} measurements (want 33) {'ok' if good else 'FAIL'}")
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
    log(f"SM clocks (highest, now): {gpu_query('clocks.max.sm,clocks.sm')}; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
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
        good &= check_unet_frames(unet, device)
        ok &= good
        log(f"phase 3 (full-width UNet, four configurations; F = 24): "
            f"{'ok' if good else 'FAIL'}")

        phase = "serving"
        pipeline = LipsyncPipeline(unet, vae, Audio2Feature(whisper), cfg,
                                   dtype=torch.bfloat16, device=device)
        good = check_finish_fetch(pipeline, device)
        ok &= good
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
        phase = "onboarding"
        good = check_onboarding(pipeline, vae, device, counters)
        ok &= good
        log(f"phase 8 (onboarding with the FAN face path on the card; a request without a "
            f"bundle and one from the new bundle): {'ok' if good else 'FAIL'}")
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
