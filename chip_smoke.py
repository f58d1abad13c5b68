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
   gives them at its default 4 windows (K10 up to C = 1280), and the flash
   route at CodeFormer's head dim 64 at 4 faces and 1 (one device kernel a
   call, none of torch's; under grad it must raise: D = 64 has no backward
   kernel); K1, K2 (both
   modes), K3 and K4 also at the half-batch shapes of a step outside the
   CFG interval (window batch 2, no CFG batch); K2's temporal
   mode and K3 also at F = 8 and 24 frames; K1, K2 and K9 also at one shape
   whose K is no multiple of the GEMM template's 64-deep k-tile and whose M
   and N are ragged; time both with CUDA events, and beside them the one
   PyTorch library call that computes the same function, where there is
   one, or the library composition (K8: ``torch._int_mm`` on codes quantized
   before the timing, and the dequantization; K2 and K5: ``F.layer_norm``,
   ``F.linear``, SDPA, ``F.linear`` and the residual; K1: the cuBLAS
   composition of the GEGLU feed-forward; K10: dequantization, that
   composition and the row quantization), timed here and used nowhere in
   the port; count the device kernels one call of each kernel's wrapper
   launches (from a CUDA graph of the call) at its first shape, and K2's, K3's, K7's
   and K10's at every shape (K2's temporal mode must be ONE kernel, two at
   C = 640; K3, K7 and K10 one); compute each kernel's bound, the least time the card
   could take for the same work, from the bytes of its inputs and outputs and the
   operations of its shapes, and for the attention kernels the time their
   exponentials alone need on the special-function units
   (``exp_bound_ms``); the int8 convolution route (im2col +
   ``torch._int_mm``) against its float64 plain version at one UNet shape
   per width and the VAE's largest ones, with equal int32 accumulators;
   the flash route's backward kernels (``csrc/flash_attention_bwd.cu``)
   against their plain version at the three shapes of a train step
   ((16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80)), each of dq,
   dk, dv within TOL_REL of its own and BWD_REL_L2_TOL in relative L2,
   two device kernels a call from the residual forward's o and lse (three
   without them) and none of torch's, a repeat call equal bit for bit, the
   residual forward's lse within LSE_TOL of the plain logsumexp; timed
   beside SDPA's backward and their bound, the residual forward beside the
   forward without grad;
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
9. the reference's production serving point (``LATENTSYNC_INT8=1
   LATENTSYNC_DEEPCACHE=4:1:enc LATENTSYNC_CFG_INTERVAL=0:0.5``): at batch 4
   a depth-1 write step (plain, ``enc``, ``enc:1``) equals the exact
   forward bit for bit, a read fed its true cache agrees with it within
   UNET_TOL, a stale cache moves it, and one ``enc`` read launches K1, K2
   and K4 and no K3; the kernel probe's ``dcread`` mode at batch 4 and 2
   with each variant's device kernels and device ms; one window batch
   denoised at the exact trajectory and at the FLOP cuts in the default and
   int8 configurations (wall, events, device ms, launches; the distance
   from the exact trajectory printed, not gated); three concurrent requests
   served with continuous batching at the production point, one device
   batch holding windows of two requests (1.8 s, 2.6 s and 1.8 s of
   audio: 3, 5 and 3 windows) and the int8 configuration's
   kernels (and no other) launched; three clips through ``run_pipelined``
   in job order beside the same clips one after another; and
   ``python -m latentsync_tpu_torch.scripts.inference --fast --device cuda``
   in a subprocess;
10. the paste-back, transcription and the job-queue worker: the host-link
   probe behind the default restore route (``LATENTSYNC_RESTORE`` unset:
   ``device`` above 200 MB/s); ``restore_frames_device`` on the card against
   its own CPU run on 64 synthetic 1920x1080 frames with 400² faces, for one
   constant align matrix and for per-frame jittered ones (within 1 code on
   at most 0.1 % of bytes), timed with its copies beside the native
   library and beside the frames' copies alone; one request with the default route and one with
   ``LATENTSYNC_RESTORE=native`` (both complete; the share of output bytes
   that differ printed); whisper-tiny at full width (random seeded weights,
   a stub tokenizer with Whisper's id layout) on one 30 s window of
   synthetic speech: teacher-forced logits card vs CPU within LOGIT_TOL,
   greedy tokens equal up to the CPU's first near tie, the encoder, the
   greedy decode and a beam of 5 timed; and ``QueueWorker`` draining three
   jobs against the server (plain, dependent and concatenated after it, with
   subtitles from that transcriber). Every request line of phases 4-10
   prints the restore route it took;
11. stage-2 training (LatentSync 1.5, ``configs/unet_stage2.yaml``): (a) the gradients of K1-K4 and the flash route through their
   ``autograd.Function``s against the plain versions' at the trainer's
   shapes (batch 1, 16 frames); (b) one full-width loss and backward (phase
   3's weights, seeded SyncNet, LPIPS and TREPA nets) with the kernels
   against the same step with every wrapper forced to its plain version on
   the card: loss and per-group gradient distances, every trainable tensor
   with a finite non-zero gradient, each kernel of the path launched (counts
   set to 0 just before), peak memory, the step's time and its split, one
   step under ``torch.profiler``; (c)
   ``python -m latentsync_tpu_torch.scripts.train_unet`` on the stage-2
   config for 4 steps in its own process on clips written here (60 frames,
   ``.wav`` sidecars), then one ``--resume`` step;
12. face restoration: (a) the full-width CodeFormer (``CodeFormer()``
   defaults, seeded random non-zero weights, positions included) in bf16 at
   1 and 4 faces of 512², w = 0.5: finite, w = 0 and w = 1 apart, the
   flash kernel launched once a transformer layer (9) a forward and no
   other kernel of the port; against the same weights in f32 with every
   wrapper forced to its plain version (TF32 off): code logits within
   UNET_TOL in relative L2, the share of equal code indices printed, the
   output given the f32 run's codes within UNET_TOL; median of 5 warm
   forwards and device ms at each batch; (b) the full-width VQGAN
   autoencoder at 4 faces, finite and timed; (c) RetinaFace (mobile0.25,
   resnet50), YOLOv5-face (n, l), ParseNet and BiSeNet in f32 (TF32 off)
   within NET_F32_TOL of the port on the CPU, RRDBNet x2 in bf16 within
   UNET_TOL; (d) ``inference_codeformer --device cuda`` in a subprocess on
   two synthetic 720p PNGs and an 8-frame ``.mp4``, then
   ``inference_vqgan`` and ``crop_align_face``, each output of the input's
   (or the requested) shape.

The line before the last is a JSON object with each kernel's launches on
its path (``"path"``: the served configuration, ``probe``, ``train`` for
the flash route's backward (phase 11 (b)), ``codeformer`` for the flash
route at D = 64 (one forward at 4 faces in phase 12 (a)) or, for K12,
``kernels``), its
largest error against the plain version, its time, the plain version's,
the library call's (or null) and its bound with the resource that sets
it; the last line is the device record.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
# the reference's production serving point and --fast mode (bench.py:32-53,
# scripts/inference.py:139-150): int8 with DeepCache 4:1:enc and CFG on the
# first half of the trajectory
FLOP_CUTS = {"LATENTSYNC_DEEPCACHE": "4:1:enc", "LATENTSYNC_CFG_INTERVAL": "0:0.5"}
SWITCHES = sorted({k for env in CONFIGS.values() for k in env} | set(FLOP_CUTS))
CACHE_MODES = {"plain": {}, "enc": {"cache_encoder": True},
               "enc:1": {"cache_encoder": True, "cache_sub": 1}}
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
    """A line of the report; a failed check's line also goes to standard
    error, so that the reason stands beside the exit code."""
    print(msg, flush=True)
    if "FAIL" in msg:
        print(msg, file=sys.stderr, flush=True)


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
def configured(conf: str, cuts: bool = False):
    """The switches of configuration `conf` (with `cuts`, and the FLOP cuts
    of the production point), and no other, for the duration (the port
    reads them at each call)."""
    old = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(CONFIGS[conf])
    if cuts:
        os.environ.update(FLOP_CUTS)
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

    def case(name, wrapper, plain, source, replaces, shapes, library=None, **extra):
        return dict(name=name, wrapper=wrapper, plain=plain, source=source, replaces=replaces,
                    shapes=shapes, library=library, **extra)

    return [
        case("geglu_ffn", ffn.geglu_ffn, ffn.geglu_ffn_reference,
             "latentsync_tpu_torch/csrc/geglu.cu", "latentsync_tpu/ops/ffn.py:82",
             [ffn_args(65536, 320), ffn_args(16384, 640), ffn_args(4096, 1280),
              ffn_args(1024, 1280),
              # a step outside the CFG interval (window batch 2, no CFG batch)
              ffn_args(32768, 320), ffn_args(8192, 640), ffn_args(2048, 1280),
              ffn_args(512, 1280),
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
              block_args(1024, 8, 640, True), block_args(1024, 24, 640, True),
              # half batch
              block_args(2048, 16, 320, True), block_args(512, 16, 640, True),
              block_args(32, 256, 640, False)],
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
              attn_args(256, 8, 1280), attn_args(256, 24, 1280),
              # half batch
              attn_args(128, 16, 1280), attn_args(32, 16, 1280)], sdpa_rows),
        case("spatial_attention", ta.spatial_attention, ta.spatial_attention_reference,
             "latentsync_tpu_torch/csrc/spatial_attention.cu",
             "latentsync_tpu/ops/temporal_attention.py:173",
             [attn_args(64, 1024, 320), attn_args(64, 64, 1280), attn_args(64, 16, 1280),
              attn_args(64, 256, 640),  # int8-dense's block at C = 640
              # a length that is no multiple of the key tile, and K2's spatial
              # mode: q/k/v pitched inside one fused projection
              attn_args(2, 100, 320), attn_args(64, 256, 640, sliced=True),
              # half batch
              attn_args(32, 1024, 320), attn_args(32, 64, 1280), attn_args(32, 16, 1280)],
             sdpa_rows),
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(64), flash_args(32),
              # the probe's spatial shapes at 4 windows, 8 heads of D = 40 and 80
              flash_args(128, 1024, 8, 40), flash_args(128, 256, 8, 80)], sdpa_bshd),
        # CodeFormer's transformer (phase 12): 8 heads of 64 over 256 tokens,
        # 4 faces and 1; one device kernel a call at every shape
        case("dot_product_attention", attention.dot_product_attention,
             attention.dot_product_attention_reference,
             "latentsync_tpu_torch/csrc/flash_attention.cu", "latentsync_tpu/ops/attention.py:85",
             [flash_args(4, 256, 8, 64), flash_args(1, 256, 8, 64)], sdpa_bshd,
             path="codeformer", one_kernel=True, grad_raises=True),
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


def _trace(fn):
    """[(name, device µs)] of the device kernels in one ``torch.profiler``
    trace of one call of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_kernels(fn, attempts: int = 8):
    """[(name, device µs)] of the device kernels one call of `fn` launches,
    from ``torch.profiler``. A call launches at least one kernel, so a
    trace with none lost its events (it happens on the card now and then,
    sometimes for several traces in a row): it is taken again, up to
    `attempts` times, each after a longer pause."""
    kernels = []
    for attempt in range(attempts):
        if attempt:
            time.sleep(0.25 * attempt)
        kernels = _trace(fn)
        if kernels:
            break
    return kernels


def graph_kernel_names(fn):
    """The names of the kernels one call of `fn` launches, read from the
    kernel nodes of a CUDA graph it is captured into (after one call
    outside the capture): every launch on the current stream becomes a
    node, so nothing is lost as a profiler trace's events can be. The
    names come from libcuda (``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName`` / ``cuKernelGetName``)."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")

    def check(code, what):
        if code:
            raise RuntimeError(f"{what}: libcuda error {code}")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode(errors="replace"))
    del graph
    torch.cuda.synchronize()
    return names


def _torch_kernel(name: str) -> bool:
    """Whether a device kernel, named as libcuda names it (mangled), is
    torch's (the wrappers' casts of parameters): ``_ZN2at...`` or
    ``...N2at6native...``."""
    return name.startswith("_ZN2at") or "2at6native" in name


def kernels_a_call(fn):
    """(the port's device kernels, torch's device kernels) that one call of
    `fn` launches, counted from the kernel nodes of a CUDA graph of the call
    (``graph_kernel_names``): a ``torch.profiler`` trace can lose some or
    all of its events on the card, a graph loses none."""
    names = graph_kernel_names(fn)
    port = sum(not _torch_kernel(n) for n in names)
    return port, len(names) - port


def device_busy(fn):
    """(device kernels, their summed device ms) of one call of `fn`."""
    kernels = device_kernels(fn)
    return len(kernels), sum(us for _, us in kernels) / 1e3


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
        if "path" in case:
            entry["path"] = case["path"]
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
            one = case.get("one_kernel", False)
            if i == 0 or name in KERNELS_A_CALL or one:
                with configured("fused"):
                    port_k, torch_k = kernels_a_call(lambda: wrapper(*args, **kw))
                if i == 0:
                    entry.update(kernels_a_call=port_k, torch_kernels_a_call=torch_k)
                good &= name not in KERNELS_A_CALL or port_k == KERNELS_A_CALL[name](label)
                good &= not one or (port_k, torch_k) == (1, 0)
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
        if case.get("grad_raises"):  # a forward kernel with no backward: under grad it raises
            args, kw = case["shapes"][0][1](r)
            before = wrapper.launches
            try:
                wrapper(args[0].requires_grad_(True), *args[1:], **kw)
                raised = ""
            except ValueError as e:
                raised = str(e)
            good = bool(raised) and wrapper.launches == before
            ok &= good
            log(f"kernel {name:22s} {case['shapes'][0][0]:28s} under grad: "
                f"{'raised (' + raised[:80] + '...)' if raised else 'did not raise'} "
                f"{'ok' if good else 'FAIL'}")
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
    return {f"{sec}s": write_speech(os.path.join(root, f"speech_{sec}.wav"), sec)
            for sec in (1.2, 2.4)}


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


def serve_requests(pipeline, root: str, audios, plan, counters, conf: str, cuts: bool = False,
                   on_state=None, **state_kw):
    """Serve `plan` [(audio, frames wanted)] in configuration `conf` (with
    `cuts`, at the production point's FLOP cuts) with every count at 0
    first; the kernels of that configuration (``ON_PATH``) must launch, and
    every other counted one must not. `state_kw` go to ``ServingState``,
    which `on_state` sees before the first request."""
    import torch

    from latentsync_tpu_torch.utils.media import read_video

    ok, jobs, launches = True, [], {}
    label = conf + (" + FLOP cuts" if cuts else "")
    # requests that overlap share the stream: their device_* stages are inclusive
    stages_note = " (device_* inclusive)" if state_kw.get("continuous_batching") else ""
    with http_server(pipeline, root, on_state, **state_kw) as base:
        for fn in counters:
            fn.launches = 0
        with configured(conf, cuts):
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
            log(f"request ({label}) audio={sec} status={job['status']} frames={frames} "
                f"(want {want}) restore_route={job.get('restore_route')} "
                f"latency_s={job.get('latency_s', float('nan')):.3f} "
                f"worker_s={job.get('elapsed', float('nan')):.3f} overlap_s={overlap:.3f} "
                f"stages{stages_note}={json.dumps(job.get('timings', {}), sort_keys=True)} "
                f"{'ok' if good else 'FAIL ' + str(job.get('error', ''))}")
    for name, n in launches.items():
        want_some = name in ON_PATH[conf]
        good = n > 0 if want_some else n == 0
        ok &= good
        log(f"launches on the served path ({label}): {name}={n} "
            f"{'ok' if good else 'FAIL'}{'' if want_some else ' (must be 0)'}")
    return launches, ok


@contextlib.contextmanager
def http_server(pipeline, root: str, on_state=None, **state_kw):
    """The port's HTTP server over `pipeline` and the avatars in `root`, on a
    free local port, for the duration; yields its base URL. `state_kw` go to
    ``ServingState``, which `on_state` sees before the first request."""
    from http.server import ThreadingHTTPServer

    from latentsync_tpu_torch.serving.api import ServingState, make_handler
    from latentsync_tpu_torch.serving.artifacts import AvatarStore

    state = ServingState(pipeline, AvatarStore(root), os.path.join(root, "out"), **state_kw)
    if on_state is not None:
        on_state(state)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
        thread.join(timeout=30)


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


def write_speech(path: str, sec: float, seed: int = SEED) -> str:
    """`sec` seconds of a tone (220 Hz, another pitch for another seed),
    amplitude-modulated at 3 Hz, with seeded noise: a 16 kHz WAV."""
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_audio

    rng = np.random.default_rng(seed)
    tt = np.arange(int(16000 * sec)) / 16000.0
    hz = 220 + 20 * (seed - SEED)
    wave = 0.3 * np.sin(2 * np.pi * hz * tt) * (1 + np.sin(2 * np.pi * 3 * tt)) \
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
            log(f"request without a bundle: frames={frames} (want 32) restore_route="
                f"{res.restore_route} faces_s={tm['faces']:.3f} "
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
                f"(want 32) restore_route={res.restore_route} device_vae_encode recorded="
                f"{'device_vae_encode' in tm} "
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


# ---------------------------------------------------------------------------
# phase 9: the production serving point
# ---------------------------------------------------------------------------


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _tree(fn, tree):
    return tuple(_tree(fn, t) for t in tree) if isinstance(tree, tuple) else fn(tree)


def check_deepcache(unet, device, counters) -> bool:
    """Phase 9.1, at batch 4 in the default configuration: a depth-1 write
    step (plain, ``enc``, ``enc:1``) is the exact forward bit for bit, a
    read fed its true cache agrees with it within UNET_TOL and a stale
    cache (x 1.5) moves it; one ``enc`` read launches K1, K2 and K4 and no
    K3 (the wrappers' counts, set to 0 just before it), and its device
    kernels are counted by ``torch.profiler``."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    cfg = unet.config
    x = torch.randn((4, cfg.in_channels, 16, 32, 32), generator=gen).to(device, torch.bfloat16)
    audio = torch.randn((4, 16, 50, cfg.cross_attention_dim), generator=gen).to(
        device, torch.bfloat16)
    t = torch.full((4,), 501, device=device)
    ok = True
    with torch.inference_mode(), configured("default"):
        base = unet(x, t, audio)
        for mode, kw in CACHE_MODES.items():
            eps, cache = unet(x, t, audio, cache_depth=1, **kw)
            bitwise = torch.equal(eps, base)
            read, _ = unet(x, t, audio, deep_cache=cache, cache_depth=1, cache_read=True, **kw)
            stale, _ = unet(x, t, audio, deep_cache=_tree(lambda c: c * 1.5, cache),
                            cache_depth=1, cache_read=True, **kw)
            rel, rel_stale = _rel_l2(read, base), _rel_l2(stale, base)
            good = bitwise and bool(torch.isfinite(read).all()) and rel <= UNET_TOL \
                and rel_stale > max(rel, 1e-3)
            ok &= good
            log(f"deepcache depth 1 {mode:5s} batch 4: write == exact forward bitwise={bitwise}; "
                f"read (true cache) rel_l2={rel:.6g} tol={UNET_TOL}; stale cache (x1.5) "
                f"rel_l2={rel_stale:.6g} {'ok' if good else 'FAIL'}")
            del eps, cache, read, stale
        kw = CACHE_MODES["enc"]
        _, cache = unet(x, t, audio, cache_depth=1, **kw)

        def enc_read():
            unet(x, t, audio, deep_cache=cache, cache_depth=1, cache_read=True, **kw)

        for fn in counters:
            fn.launches = 0
        enc_read()
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters}
        n_dev, dev_ms = device_busy(enc_read)
    ran = {k: counts[k] for k in ("geglu_ffn", "self_attention_block", "spatial_attention")}
    good = counts["temporal_attention"] == 0 and all(ran.values()) and n_dev > 0
    ok &= good
    log(f"one enc read at batch 4: temporal_attention={counts['temporal_attention']} "
        f"(must be 0) {' '.join(f'{k}={v}' for k, v in ran.items())} (must be > 0); "
        f"{n_dev} device kernels, {dev_ms:.3f} device ms {'ok' if good else 'FAIL'}")
    return ok


def run_dcread(unet, device) -> bool:
    """Phase 9.2: the probe's ``dcread`` mode in process at batch 4 and 2
    (``--w`` 2 and 1) on the served model, and beside each of its three
    variants the device kernels and device ms of one call
    (``torch.profiler``)."""
    import torch

    from latentsync_tpu_torch.scripts import micro_probe

    ok = True
    cfg = unet.config
    for w in (2, 1):
        b = 2 * w
        probe = micro_probe.Probe(device, w=w, iters=10,
                                  emit=lambda rec: log("probe " + json.dumps(rec)))
        with configured("default"):
            micro_probe.run(probe, "dcread", unet=unet)
            gen = torch.Generator().manual_seed(SEED + 8)
            x = torch.randn((b, cfg.in_channels, 16, 32, 32), generator=gen).to(
                device, torch.bfloat16)
            audio = torch.randn((b, 16, 50, cfg.cross_attention_dim), generator=gen).to(
                device, torch.bfloat16)
            t = torch.full((b,), 500, device=device)
            with torch.inference_mode():
                caches = {name: unet(x, t, audio, cache_depth=1, **CACHE_MODES[name])[1]
                          for name in ("plain", "enc")}
                calls = {"full": lambda: unet(x, t, audio)}
                for name in ("plain", "enc"):
                    calls[f"read_{name}"] = functools.partial(
                        unet, x, t, audio, deep_cache=caches[name], cache_depth=1,
                        cache_read=True, **CACHE_MODES[name])
                busy = {name: device_busy(fn) for name, fn in calls.items()}
            del caches
        ms = {rec["name"]: rec["ms"] for rec in probe.results}
        for name, (n_dev, dev_ms) in busy.items():
            probe_ms = ms.get(f"unet_{name}_b{b}", float("nan"))
            good = math.isfinite(probe_ms) and probe_ms > 0 and n_dev > 0
            ok &= good
            log(f"dcread batch {b} {name:10s}: ms={probe_ms:.3f} (probe, CUDA events over "
                f"chained calls) device_kernels={n_dev} device_ms={dev_ms:.3f} "
                f"{'ok' if good else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok


def time_denoise(pipeline, device, counters) -> bool:
    """Phase 9.3: one window batch (W = 2, 20 DDIM steps, CFG 1.5) at the
    exact trajectory and at the production point's FLOP cuts, in the
    default and the int8 configuration, warm: wall time, the CUDA events'
    span on the stream, the device kernels' sum (``torch.profiler``, one
    more call) and the wrappers' launches. Latents finite; the relative L2
    from the exact trajectory is printed, not gated (random weights)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 9)
    w, f, lat = 2, 16, 32
    lat0 = (torch.randn((1, 1, lat, lat, 4), generator=gen)
            .expand(w, f, lat, lat, 4).to(device))
    mask = torch.ones((w, f, lat, lat, 1), device=device)
    masked, ref = (torch.randn((w, f, lat, lat, 4), generator=gen).to(device) for _ in range(2))
    audio = torch.randn((w, f, 50, 384), generator=gen).to(device)

    def denoise():
        return pipeline._denoise(lat0, mask, masked, ref, audio, 20, 1.5)

    ok = True
    for conf in ("default", "int8"):
        exact = None
        for cuts in (False, True):
            with configured(conf, cuts):
                denoise()
                for fn in counters:
                    fn.launches = 0
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                out = denoise()
                end.record()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launches = {fn.__name__: fn.launches for fn in counters if fn.launches}
                n_dev, dev_ms = device_busy(denoise)
            finite = bool(torch.isfinite(out).all())
            good = finite and tuple(out.shape) == (w, f, lat, lat, 4)
            ok &= good
            rel = "" if exact is None else f" rel_l2_vs_exact={_rel_l2(out, exact):.6g}"
            label = "4:1:enc + 0:0.5" if cuts else "exact"
            log(f"denoise W=2 20 steps ({conf}, {label}): wall_ms={wall_ms:.3f} "
                f"events_ms={start.elapsed_time(end):.3f} device_kernels={n_dev} "
                f"device_ms={dev_ms:.3f} launches={json.dumps(launches, sort_keys=True)} "
                f"finite={finite}{rel} {'ok' if good else 'FAIL'}")
            if exact is None:
                exact = out
    return ok


def serve_production(pipeline, root: str, counters):
    """Phase 9.4: three concurrent requests (1.8 s, 2.6 s and 1.8 s of three
    different speech tracks: 3, 5 and 3 windows) over HTTP, continuous
    batching (two workers, batches of two windows), at the production point.
    A request submits its windows together, so at batches of two an even
    count pairs up within the request; an odd one leaves a window to share
    a batch with the next request's. The batch function is wrapped here to
    name the request of each window of a batch (each window's audio against
    the windows ``prepare`` gave each request): at least one batch must
    hold windows of two requests."""
    import torch

    audios = {f"{sec}s #{i}": write_speech(os.path.join(root, f"prod_{i}.wav"), sec,
                                           seed=SEED + 1 + i)
              for i, sec in enumerate((1.8, 2.6, 1.8))}
    plan = [(label, 80 if label.startswith("2.6") else 48) for label in audios]
    lock = threading.Lock()
    prepared, requests_a_batch = [], []
    prepare = pipeline.prepare

    def prepare_spy(*a, **k):
        state = prepare(*a, **k)
        with lock:
            prepared.append(state.audio_w)
        return state

    def wrap(state):
        batcher = state._batchers[(20, 1.5)]
        batch_fn = batcher.batch_fn

        def batch_spy(stacked):
            with lock:
                known = list(enumerate(prepared))
            owners = {j for row in stacked["audio"] for j, windows in known
                      if any(torch.equal(row, win) for win in windows)}
            requests_a_batch.append(len(owners))
            return batch_fn(stacked)

        batcher.batch_fn = batch_spy

    pipeline.prepare = prepare_spy
    try:
        launches, ok = serve_requests(pipeline, root, audios, plan, counters, "int8", cuts=True,
                                      on_state=wrap, continuous_batching=True, batch_windows=2,
                                      num_workers=2)
    finally:
        del pipeline.prepare
    good = len(prepared) == 3 and max(requests_a_batch, default=0) >= 2
    ok &= good
    log(f"continuous batching: {len(requests_a_batch)} device batches of 2 windows, requests "
        f"a batch {requests_a_batch} (one must hold two) {'ok' if good else 'FAIL'}")
    return launches, ok


def check_pipelined(pipeline, root: str, audios) -> bool:
    """Phase 9.5: three clips (1.2 s, 2.4 s, 1.2 s) through ``run_pipelined``
    in the default configuration: outputs in job order with the right frame
    counts; its wall time beside the sum of the three clips served one after
    another in the same call. Overlapped clips share the stream, so their
    ``device_*`` stages are inclusive."""
    from latentsync_tpu_torch.utils.media import read_video

    video, bundle = os.path.join(root, "avatar.mp4"), os.path.join(root, "avatar.npz")
    plan = [("1.2s", 32), ("2.4s", 64), ("1.2s", 32)]
    ok = True
    with configured("default"):
        serial_s = 0.0
        for i, (key, _) in enumerate(plan):
            t0 = time.time()
            pipeline(video, audios[key], os.path.join(root, f"serial_{i}.mp4"), data_path=bundle)
            serial_s += time.time() - t0
        jobs = [(video, audios[key], os.path.join(root, f"pipelined_{i}.mp4"))
                for i, (key, _) in enumerate(plan)]
        t0 = time.time()
        outs = pipeline.run_pipelined(jobs, data_path=bundle)
        wall_s = time.time() - t0
    for (_, _, path), out, (key, want) in zip(jobs, outs, plan):
        frames = read_video(out.video_path, change_fps=False).shape[0]
        good = out.video_path == path and out.num_frames == want == frames
        ok &= good
        log(f"run_pipelined clip audio={key}: frames={frames} (want {want}) restore_route="
            f"{out.restore_route} total_s="
            f"{out.elapsed['total']:.3f} device_denoise_s (inclusive)="
            f"{out.elapsed.get('device_denoise', float('nan')):.3f} {'ok' if good else 'FAIL'}")
    log(f"run_pipelined: 3 clips in {wall_s:.3f} s wall, the same clips one after another "
        f"{serial_s:.3f} s (ratio {wall_s / serial_s:.3f})")
    return ok


def run_cli(root: str, audios) -> bool:
    """Phase 9.6: ``python -m latentsync_tpu_torch.scripts.inference --fast
    --device cuda`` in a subprocess on the synthetic avatar and its bundle
    (random seeded weights: no checkpoint files): it exits 0 and its JSON
    line has the frame count."""
    out = os.path.join(root, "cli.mp4")
    cmd = [sys.executable, "-m", "latentsync_tpu_torch.scripts.inference", "--video",
           os.path.join(root, "avatar.mp4"), "--audio", audios["1.2s"], "--out", out,
           "--data-path", os.path.join(root, "avatar.npz"), "--fast", "--device", "cuda"]
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    record = {}
    if proc.returncode == 0 and lines:
        record = json.loads(lines[-1])
    good = proc.returncode == 0 and record.get("frames") == 32
    log(f"inference CLI --fast --device cuda: rc={proc.returncode} frames={record.get('frames')} "
        f"(want 32) wall_s={time.time() - t0:.1f} stages="
        f"{json.dumps(record.get('timings', {}), sort_keys=True)} {'ok' if good else 'FAIL'}")
    if not good:
        log(proc.stderr[-3000:])
    return good


# ---------------------------------------------------------------------------
# phase 10: device restore, transcription, the job-queue worker
# ---------------------------------------------------------------------------

# device restore on the card against its own CPU run: every byte within 1
# code, at most 0.1 % of bytes off (a value within a rounding of an integer
# may truncate either way)
RESTORE_MAX_CODE, RESTORE_MAX_SHARE = 1, 1e-3
# whisper-tiny's teacher-forced logits, card against CPU, both f32 (TF32 off
# in the encoder's convolutions; products without TF32): within 1e-3 of the
# largest |logit|
LOGIT_TOL = 1e-3


@contextlib.contextmanager
def restore_switch(value):
    """``LATENTSYNC_RESTORE`` set to `value` (None: unset) for the duration."""
    old = os.environ.pop("LATENTSYNC_RESTORE", None)
    if value is not None:
        os.environ["LATENTSYNC_RESTORE"] = value
    try:
        yield
    finally:
        os.environ.pop("LATENTSYNC_RESTORE", None)
        if old is not None:
            os.environ["LATENTSYNC_RESTORE"] = old


def check_transport(device) -> bool:
    """Phase 10.1: the host link probe behind the default restore route."""
    from latentsync_tpu_torch.pipelines import lipsync

    rate = lipsync._transport_rate(device)
    fast = lipsync._transport_is_fast(device)
    with restore_switch(None):
        route = lipsync.restore_route(device)
    good = fast == (rate > 200.0) and route == ("device" if fast else "native")
    log(f"[{gpu_line()}] transport probe: 4 MB host->device {rate:.1f} MB/s, fast={fast} "
        f"(threshold 200 MB/s), default restore route={route} {'ok' if good else 'FAIL'}")
    return good


def check_device_restore(device) -> bool:
    """Phase 10.2: ``restore_frames_device`` on the card against the same
    function on the CPU, on 64 synthetic 1920x1080 frames with 400² faces,
    for one constant align matrix (the served case: the face lands on whole
    pixels) and for per-frame jittered ones; the device route (copies to the
    card and back included) timed beside the native library on the same
    frames, and the frames' copies up and back timed alone."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.ops.restore import edge_radius, restore_frames_device
    from latentsync_tpu_torch.utils import native

    rng = np.random.default_rng(SEED)
    n, h, w, fs = 64, 1080, 1920, 400
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 80 * np.sin(xx / 71 + c) * np.cos(yy / 53 - c) for c in range(3)], -1)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i, shift in enumerate(rng.normal(0, 6, (n, 3)).astype(np.float32)):
        frames[i] = np.clip(base + shift, 0, 255)
    faces = rng.integers(0, 256, (n, fs, fs, 3), dtype=np.uint8)
    const = np.repeat(np.array([[1.0, 0.0, -760.0], [0.0, 1.0, -300.0]])[None], n, 0)
    theta = rng.normal(0, 0.02, n)
    scale = 1.0 + rng.normal(0, 0.02, n)
    jitter = np.stack([np.array([[s * np.cos(t), -s * np.sin(t), -760.0 + dx],
                                 [s * np.sin(t), s * np.cos(t), -300.0 + dy]])
                       for t, s, dx, dy in zip(theta, scale, rng.normal(0, 4, n),
                                               rng.normal(0, 4, n))])
    # the copies the device route makes, alone: the frames up and back (pageable)
    torch.from_numpy(frames[:8]).to(device).cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = torch.from_numpy(frames).to(device)
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    on_card.cpu()
    back_ms = (time.perf_counter() - t0) * 1e3
    del on_card
    log(f"[{gpu_line()}] the frames' copies alone ({frames.nbytes / 2**20:.0f} MiB, pageable): "
        f"up {up_ms:.1f} ms ({frames.nbytes / up_ms / 1e6:.2f} GB/s), back {back_ms:.1f} ms "
        f"({frames.nbytes / back_ms / 1e6:.2f} GB/s)")
    ok = True
    for label, mats in (("constant matrix", const), ("per-frame matrices", jitter)):
        restore_frames_device(frames[:8], faces[:8], mats[:8], device=device)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = restore_frames_device(frames, faces, mats, device=device)
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = restore_frames_device(frames, faces, mats, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        scratch = frames.copy()
        t0 = time.perf_counter()
        if label.startswith("constant"):
            native.restore_frames_const_native(scratch, faces, mats[0], copy=False)
        else:
            native.restore_frames_native(scratch, faces, mats, copy=False)
        native_ms = (time.perf_counter() - t0) * 1e3
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        share = float((d > 0).mean())
        good = got.shape == frames.shape and int(d.max()) <= RESTORE_MAX_CODE \
            and share <= RESTORE_MAX_SHARE and float((got != frames).mean()) > 0.01
        ok &= good
        log(f"[{gpu_line()}] device restore ({label}, {n} x {w}x{h}, faces {fs}², edge "
            f"{edge_radius(mats, (fs, fs))}): card vs CPU max {int(d.max())} code(s), "
            f"{100 * share:.4f}% of bytes differ (limits {RESTORE_MAX_CODE}, "
            f"{100 * RESTORE_MAX_SHARE:.1f}%); device_ms={dev_ms:.1f} (with the copies) "
            f"native_ms={native_ms:.1f} cpu_device_route_ms={cpu_ms:.1f} "
            f"{'ok' if good else 'FAIL'}")
    return ok


def serve_both_routes(pipeline, root: str, audios) -> bool:
    """Phase 10.3: one request through the HTTP server with the default
    restore route and one with ``LATENTSYNC_RESTORE=native``: both complete
    with the right frame count; the share of output bytes that differ is
    printed (the two composites are different functions)."""
    import numpy as np

    from latentsync_tpu_torch.pipelines.lipsync import restore_route
    from latentsync_tpu_torch.utils.media import read_video

    ok, outputs = True, {}
    for value in (None, "native"):
        with restore_switch(value):
            route = restore_route(pipeline.device)
            with http_server(pipeline, root) as base:
                with configured("default"):
                    (job_id, t_sub), = submit_all(base, audios, [("1.2s", 32)])
                    job = wait_all(base, [(job_id, t_sub)])[job_id]
        frames = read_video(job["output"], change_fps=False) if job["status"] == "completed" \
            else None
        n = -1 if frames is None else len(frames)
        tm = job.get("timings", {})
        good = job["status"] == "completed" and n == 32 == job.get("num_frames") \
            and job.get("restore_route") == route
        ok &= good
        outputs[value] = frames
        nan = float("nan")
        overlap = tm.get("vae_decode", nan) + tm.get("restore", nan) \
            - tm.get("decode_restore_total", nan)
        log(f"[{gpu_line()}] request (default configuration, LATENTSYNC_RESTORE="
            f"{value or 'unset'}) restore_route={job.get('restore_route')} frames={n} (want 32) "
            f"restore_s={tm.get('restore', nan):.4f} decode_restore_total_s="
            f"{tm.get('decode_restore_total', nan):.4f} overlap_s={overlap:.4f} "
            f"{'ok' if good else 'FAIL ' + str(job.get('error', ''))}")
    if ok:
        a, b = outputs[None], outputs["native"]
        log(f"device vs native route, the same request: {100 * float((a != b).mean()):.3f}% of "
            f"output bytes differ (the two composites differ; not gated)")
    return ok


class StubTokenizer:
    """Whisper's multilingual id layout (end of text 50257, start of
    transcript 50258, 99 languages, timestamps from 50364) without a
    vocabulary: text ids decode to ``w<id>``."""

    eot, sot, no_timestamps, sot_prev, timestamp_begin = 50257, 50258, 50363, 50361, 50364
    sot_sequence = (50258, 50259, 50359)  # <|startoftranscript|><|en|><|transcribe|>

    def encode(self, text):
        return [220] if text == " " else [(ord(c) % 200) + 30 for c in text]

    def decode(self, toks):
        return " " + " ".join(f"w{int(t)}" for t in toks)

    def suppress_set(self):
        return tuple(range(50258, 50363))  # start of transcript ... no speech


def check_transcription(device, root: str):
    """Phase 10.4: whisper-tiny at full width (4 + 4 layers, width 384, vocab
    51865, text context 448, random seeded weights, the stub tokenizer) on
    one 30 s window of synthetic speech: teacher-forced logits on the card
    against the CPU in f32; greedy tokens equal to the CPU's up to the first
    position where the CPU's top-two gap (after the logit filters) is below
    LOGIT_TOL of the largest |logit|; the encoder, the greedy decode and a
    beam of 5 timed. Returns (ok, the card's transcriber)."""
    import numpy as np
    import torch

    from latentsync_tpu_torch.audio.transcribe import WhisperTranscriber
    from latentsync_tpu_torch.config import WhisperConfig
    from latentsync_tpu_torch.models import whisper_decoder as wd
    from latentsync_tpu_torch.models.whisper import WhisperEncoder
    from latentsync_tpu_torch.ops.mel import WHISPER_N_FRAMES, pad_or_trim, whisper_log_mel
    from latentsync_tpu_torch.utils.convert import init_random_
    from latentsync_tpu_torch.utils.media import read_audio

    cfg = WhisperConfig.tiny()
    enc = init_random_(WhisperEncoder(cfg), seed=SEED + 7)
    dec = init_random_(wd.WhisperTextDecoder(cfg), seed=SEED + 8)
    tok = StubTokenizer()
    cpu = WhisperTranscriber(enc, dec, tok)
    card = WhisperTranscriber(WhisperEncoder(cfg).to(device), wd.WhisperTextDecoder(cfg).to(device),
                              tok)
    card.encoder.load_state_dict(enc.state_dict())
    card.decoder.load_state_dict(dec.state_dict())
    wav = write_speech(os.path.join(root, "speech_30.wav"), 30.0, seed=SEED + 9)
    audio = read_audio(wav)
    sot = tok.sot_sequence
    feats, tokens = {}, {}
    for name, tr in (("cpu", cpu), ("card", card)):
        mel = whisper_log_mel(torch.as_tensor(audio, device=tr.device))
        feats[name] = tr.encode(pad_or_trim(mel, WHISPER_N_FRAMES))
        tokens[name], _ = wd.greedy_decode(tr.decoder, feats[name], sot, tr.rules)
    # teacher-forced logits over the CPU's decoded sequence
    seq = torch.from_numpy(tokens["cpu"].astype(np.int64))
    with torch.inference_mode():
        want = cpu.decoder(seq, feats["cpu"])
        got = card.decoder(seq.to(device), feats["card"]).cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= LOGIT_TOL * scale
    log(f"[{gpu_line()}] whisper-tiny teacher-forced logits ({seq.shape[1]} tokens x 51865) card "
        f"vs CPU: max err {err:.3e} (limit {LOGIT_TOL:g} x max|logit| {scale:.3f}) "
        f"{'ok' if ok else 'FAIL'}")
    # the CPU's decisions and their margins, after the logit filters
    sb = len(sot)
    suppress = wd._suppress_mask(card.rules, cfg.n_vocab, "cpu")
    needed = 0
    for pos in range(sb - 1, seq.shape[1] - 1):
        row = wd._apply_logit_filters(want[:, pos].clone(), seq, pos, cpu.rules, sb, suppress)
        top2 = row[0].topk(2).values
        if float(top2[0] - top2[1]) < LOGIT_TOL * scale or int(seq[0, pos + 1]) == tok.eot:
            needed += int(float(top2[0] - top2[1]) >= LOGIT_TOL * scale)
            break
        needed += 1
    a, b = tokens["cpu"][0, sb:], tokens["card"][0, sb:]
    agree = int(np.argmin(a == b)) if (a != b).any() else len(a)
    good = agree >= needed
    ok &= good
    log(f"[{gpu_line()}] greedy t=0, card vs CPU: {agree} leading sampled tokens agree "
        f"(required: {needed}, up to the first CPU top-two gap below the limit or the end "
        f"of text) {'ok' if good else 'FAIL'}")

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2], out

    steps = collections.Counter()
    step = card.decoder.step

    def counted(*a, **k):
        steps["n"] += 1
        return step(*a, **k)

    card.decoder.step = counted
    try:
        enc_ms, _ = timed(lambda: card.encode(pad_or_trim(whisper_log_mel(
            torch.as_tensor(audio, device=device)), WHISPER_N_FRAMES)))
        for label, fn in (("greedy", lambda: wd.greedy_decode(card.decoder, feats["card"], sot,
                                                               card.rules)),
                          ("beam 5", lambda: wd.beam_decode(card.decoder, feats["card"], sot,
                                                             card.rules, beam_size=5))):
            steps.clear()
            fn()
            n_steps = steps["n"]
            ms, (toks, lp) = timed(fn)
            n_sampled = int((toks[0, sb:] != tok.eot).sum())
            good = np.isfinite(lp).all() and n_steps >= sb
            ok &= good
            log(f"[{gpu_line()}] whisper-tiny {label} decode on the card: {ms:.1f} ms, "
                f"{n_steps} steps ({n_steps / ms * 1e3:.1f} steps/s), {n_sampled} tokens kept "
                f"({n_sampled / ms * 1e3:.1f} tokens/s), encoder {enc_ms:.1f} ms for the 30 s "
                f"window {'ok' if good else 'FAIL'}")
    finally:
        del card.decoder.step
    return ok, card


def run_worker(pipeline, root: str, audios, transcriber) -> bool:
    """Phase 10.5: ``LocalDirQueue`` with three jobs drained by ``QueueWorker``
    against the running server: a plain one, one ``waiting-dependency`` on it
    that is concatenated after its output (``concat_with``), and one with
    subtitles from the card's transcriber. All complete; the concatenation
    has the frames of both parts; the subtitles come back as a VTT data URI."""
    from latentsync_tpu_torch.serving.worker import LocalDirQueue, QueueWorker
    from latentsync_tpu_torch.utils.media import read_video

    q = LocalDirQueue(os.path.join(root, "queue"))
    q.submit({"id": "job-a", "avatar_id": "avatar", "audio_path": audios["1.2s"]})
    q.submit({"id": "job-b", "avatar_id": "avatar", "audio_path": audios["2.4s"],
              "status": "waiting-dependency", "dependencies": ["job-a"],
              "concat_with": ["job-a"]})
    q.submit({"id": "job-c", "avatar_id": "avatar", "audio_path": audios["1.2s"],
              "subtitles": True})
    t0 = time.time()
    with http_server(pipeline, root) as base, configured("default"):
        handled = QueueWorker(q, api_url=base, transcriber=transcriber).run_once()
    wall = time.time() - t0
    jobs = {j: q.get(j) for j in ("job-a", "job-b", "job-c")}
    status = {j: job["status"] for j, job in jobs.items()}
    ok = handled == 3 and set(status.values()) == {"completed"}
    n = {}
    if ok:
        n = {j: read_video(job["output"], change_fps=False).shape[0] for j, job in jobs.items()}
        ok = n == {"job-a": 32, "job-b": 32 + 64, "job-c": 32} \
            and jobs["job-b"].get("concatenated") is True \
            and str(jobs["job-c"].get("subtitles_uri", "")).startswith("data:text/vtt;base64,")
    log(f"[{gpu_line()}] job-queue worker: {handled} jobs in {wall:.1f} s, status {status}, "
        f"frames {n} (want job-b = 32 + 64), subtitles_uri "
        f"{str(jobs['job-c'].get('subtitles_uri', ''))[:40]}... "
        f"{'ok' if ok else 'FAIL ' + str({j: job.get('error') for j, job in jobs.items()})}")
    return ok


# ---------------------------------------------------------------------------
# phase 11: stage-2 training on the card
# ---------------------------------------------------------------------------

# the flash backward's shapes in a train step: the VAE mid-block's attention
# in the decode of x̂₀ (16 frames of 32² latents), then the UNet's spatial
# attention at 32² (C = 320) and 16² (C = 640) through K4's and K2's
# composed gradients
FLASH_BWD_SHAPES = [(16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80)]
# the residual forward's lse against the plain f32 logsumexp, natural units
LSE_TOL = 1e-3
# the flash backward's relative L2 error a gradient, beside TOL_REL: where
# max|plain| < 1 the latter is absolute (2^-6), and this one also holds terms
# that are small beside dp, such as delta
BWD_REL_L2_TOL = 1e-2
# the share of the two runs' gradients (kernels vs every wrapper's plain
# version, both bf16) above which a group's gradient is a fault, not rounding
GRAD_TOL = 0.25
# the trainer's shapes at batch 1, 16 frames, 32² latents: (label, wrapper,
# plain version, tensors (shape, scale, shift), keyword arguments)
TRAIN_FN_CASES = [
    ("geglu_ffn", "M=16384 C=320", 16384, 320), ("geglu_ffn", "M=4096 C=640", 4096, 640),
    ("geglu_ffn", "M=1024 C=1280", 1024, 1280),
    # SyncNet's feed-forward widths and rows: the reference's routing (and
    # so the port's, geglu_route) gives them the composed form, never K1;
    # the kernel is held at them all the same
    ("geglu_ffn", "M=130 C=256 (SyncNet)", 130, 256),
    ("geglu_ffn", "M=16 C=1024 (SyncNet)", 16, 1024),
    ("self_attention_block", "temporal B=1024 S=16 C=320", 1024, 16, 320, True),
    ("self_attention_block", "temporal B=256 S=16 C=640", 256, 16, 640, True),
    ("self_attention_block", "spatial B=16 S=256 C=640", 16, 256, 640, False),
    ("temporal_attention", "B=64 F=16 heads*D=1280", 64, 16, 1280),
    ("spatial_attention", "B=16 S=1024 heads*D=320", 16, 1024, 320),
    ("spatial_attention", "B=16 S=64 heads*D=1280", 16, 64, 1280),
    ("spatial_attention", "B=16 S=16 heads*D=1280", 16, 16, 1280),
    ("dot_product_attention", "B=16 S=1024 H=1 D=512", 16, 1024, 1, 512),
]


def _per_output(got, ref):
    """(largest error, its tolerance, all within): each output against
    TOL_REL · max(1, max|plain|) of its own."""
    import torch

    errs, ok = [], True
    for g, r in zip(got, ref):
        err = float((g.float() - r.float()).abs().max())
        tol = TOL_REL * max(1.0, float(r.float().abs().max()))
        ok &= err <= tol and bool(torch.isfinite(g).all())
        errs.append((err / tol, err, tol))
    worst = max(errs)
    return worst[1], worst[2], ok


def check_flash_backward(device):
    """Phase 2, last: the flash route's backward kernels against their plain
    version at the three shapes a train step gives them (FLASH_BWD_SHAPES),
    each gradient within TOL_REL of its own and BWD_REL_L2_TOL in relative
    L2, and each shape timed beside the plain version and SDPA's backward
    (from one forward graph kept for repeated backwards) with the bound of
    the function itself: the five products it needs, and q, k, v, do read
    and dq, dk, dv written once. The backward takes the forward's output
    and row log-sum-exp from the residual forward (``flash_attention_fwd``),
    as the train step's Function does: two device kernels a call, three when
    the call has to run the residual forward itself, and none of torch's. A
    second call must equal the first bit for bit, and the residual forward's
    lse must be within LSE_TOL of the plain f32 logsumexp of the scaled
    logits; its time is logged beside the forward without grad. Returns
    (the kernels line's entry, ok)."""
    import torch
    import torch.nn.functional as F

    from latentsync_tpu_torch.ops import attention

    entry, ok = None, True
    for i, (b, s, h, d) in enumerate(FLASH_BWD_SHAPES):
        gen = torch.Generator().manual_seed(SEED + 11 + i)
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).to(device, torch.bfloat16)
                       for _ in range(4))
        scale = d**-0.5
        o, lse = attention.flash_attention_fwd(q, k, v, scale)
        lse_ref = attention.flash_attention_fwd_reference(q, k, v, scale)[1]
        lse_err = float((lse - lse_ref).abs().max()) * math.log(2.0)  # natural units
        del lse_ref
        before = attention.flash_attention_bwd.launches
        got = attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse)
        again = attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse)
        direct = attention.flash_attention_bwd(q, k, v, do, scale)  # its own residual forward
        ref = attention.flash_attention_bwd_reference(q, k, v, do, scale)
        torch.cuda.synchronize()
        launched = attention.flash_attention_bwd.launches == before + 3
        err, tol, close = _per_output(got, ref)
        rel = max(_rel_l2(g, r) for g, r in zip(got, ref))
        bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
        same_direct = all(torch.equal(x, y) for x, y in zip(got, direct))
        del again, direct, ref
        port_k, torch_k = kernels_a_call(
            lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        port_d, torch_d = kernels_a_call(lambda: attention.flash_attention_bwd(q, k, v, do, scale))
        dev_n, dev_ms = device_busy(
            lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        ms = cuda_ms(lambda: attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse))
        plain_ms = cuda_ms(lambda: attention.flash_attention_bwd_reference(q, k, v, do, scale))
        fwd_ms = cuda_ms(lambda: attention.flash_attention_fwd(q, k, v, scale))
        with torch.no_grad():
            nograd_ms = cuda_ms(lambda: attention.dot_product_attention(q, k, v, scale))
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dot,
                                                         retain_graph=True))
        # the function's own tensors: q, k, v, do in, dq, dk, dv out
        bound_ms, bound_by = bound((q, k, v, do), {}, got, 10 * b * h * s * s * d, "bf16")
        good = launched and close and rel <= BWD_REL_L2_TOL and bitwise and same_direct \
            and lse_err <= LSE_TOL and port_k == 2 and torch_k == 0 and port_d == 3 \
            and torch_d == 0
        ok &= good
        label = f"B={b} S={s} H={h} D={d}"
        log(f"kernel flash_attention_bwd    {label:28s} max_abs_err={err:.6g} tol={tol:.6g} (each "
            f"of dq, dk, dv against its own) rel_l2={rel:.4g} (tol {BWD_REL_L2_TOL}, each) "
            f"bitwise_repeat={bitwise} "
            f"same_without_residuals={same_direct} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"({dev_n} kernels) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA "
            f"backward) bound_ms={bound_ms:.4f} ({bound_by}) share={bound_ms / ms:.3f} "
            f"kernels_a_call={port_k} (+{torch_k} torch), without residuals {port_d} "
            f"(+{torch_d} torch) {'ok' if good else 'FAIL'}")
        log(f"kernel flash_attention_fwd    {label:28s} residual forward ms={fwd_ms:.4f} beside "
            f"the forward without grad ms={nograd_ms:.4f}; lse max_abs_err={lse_err:.3g} "
            f"(natural units, tol {LSE_TOL}) {'ok' if lse_err <= LSE_TOL else 'FAIL'}")
        shape = {"shape": label, "max_abs_err": err, "rel_l2": rel, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by, "kernels_a_call": port_k,
                 "residual_forward_ms": fwd_ms, "forward_without_grad_ms": nograd_ms}
        if entry is None:
            entry = {"name": "flash_attention_bwd", "route": "cuda",
                     "source": "latentsync_tpu_torch/csrc/flash_attention_bwd.cu",
                     "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
                     "launches": 0, "torch_kernels_a_call": torch_k, "shapes": [],
                     **{k_: shape[k_] for k_ in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "kernels_a_call")},
                     "shape": label}
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shapes"].append(shape)
        del q, k, v, do, o, lse, got, out, qs, ks, vs
        torch.cuda.empty_cache()
    return entry, ok


def check_function_grads(device) -> bool:
    """Phase 11 (a): the gradients of K1-K4 and the flash route through their
    ``autograd.Function``s (the kernel forward, the composed backward on the
    card's kernels) against the autograd of the same call's plain version,
    at the trainer's shapes, each input and weight within TOL_REL."""
    import torch

    from latentsync_tpu_torch.ops import attention, attn_block, ffn
    from latentsync_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator().manual_seed(SEED + 12)

    def r(*shape, s=1.0, add=0.0):
        return (torch.randn(shape, generator=gen) * s + add).to(device, torch.bfloat16) \
            .requires_grad_(True)

    def case(name, *dims):
        if name == "geglu_ffn":
            m, c = dims
            args = [r(m, c), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1),
                    r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1), r(c, s=0.1, add=1.0),
                    r(c, s=0.1)]
            return (args, lambda *a: ffn.geglu_ffn(*a, residual=True),
                    lambda *a: ffn.geglu_ffn_reference(*a, residual=True))
        if name == "self_attention_block":
            b, s, c, temporal = dims
            args = [r(b, s, c), r(c, s=0.1, add=1.0), r(c, s=0.1),
                    *[r(c, c, s=c**-0.5) for _ in range(4)], r(c, s=0.1)]
            pe = [r(s, c)] if temporal else []

            def call(fn):
                return lambda *a: fn(*a[:8], 8, temporal=temporal,
                                     pe=a[8] if temporal else None)
            return (args + pe, call(attn_block.self_attention_block),
                    call(attn_block.self_attention_block_reference))
        if name == "dot_product_attention":
            return ([r(*dims) for _ in range(3)], attention.dot_product_attention,
                    attention.dot_product_attention_reference)
        fn, plain = {"temporal_attention": (ta.temporal_attention,
                                            ta.temporal_attention_reference),
                     "spatial_attention": (ta.spatial_attention,
                                           ta.spatial_attention_reference)}[name]
        return ([r(*dims) for _ in range(3)], lambda q, k, v: fn(q, k, v, 8),
                lambda q, k, v: plain(q, k, v, 8))

    ok = True
    for name, label, *dims in TRAIN_FN_CASES:
        args, fn, plain = case(name, *dims)
        out = fn(*args)
        has_fn = out.grad_fn is not None
        cot = torch.randn(out.shape, generator=gen).to(out)
        got = torch.autograd.grad(out, args, cot)
        ref = torch.autograd.grad(plain(*args), args, cot)
        torch.cuda.synchronize()
        err, tol, close = _per_output(got, ref)
        good = has_fn and close
        ok &= good
        log(f"grad {name:22s} {label:28s} grad_fn={has_fn} {len(args)} gradients, worst "
            f"max_abs_err={err:.6g} tol={tol:.6g} {'ok' if good else 'FAIL'}")
        del args, out, got, ref
    torch.cuda.empty_cache()
    return ok


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper with a gradient runs its plain version on the card
    for the duration (the forwards of K1-K4 and the flash route, the flash
    route's backward); the Functions and their composed backwards stay."""
    from latentsync_tpu_torch.ops import attention, attn_block, ffn
    from latentsync_tpu_torch.ops import temporal_attention as ta

    def k1(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias, residual, eps):
        return ffn.geglu_ffn_reference(x, w_up, b_up, w_down, b_down, ln_scale, ln_bias,
                                       residual, eps)

    def flash_forward(q, k, v, scale, with_lse=False):
        o = attention.dot_product_attention_reference(q, k, v, scale)
        return (o, None) if with_lse else o

    def flash_backward(q, k, v, grad, scale, o=None, lse=None):
        return attention.flash_attention_bwd_reference(q, k, v, grad, scale)

    patches = [(ffn, "_geglu_ffn_kernel", k1),
               (attn_block, "self_attention_block_fused",
                attn_block.self_attention_block_reference),
               (ta, "_temporal_kernel", ta.temporal_attention_reference),
               (ta, "_spatial_kernel", lambda q, k, v, heads, scale, block_q:
                ta.spatial_attention_reference(q, k, v, heads, scale)),
               (attention, "_flash_forward", flash_forward),
               (attention, "flash_attention_bwd", flash_backward)]
    old = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, fn in patches:
        setattr(m, n, fn)
    try:
        yield
    finally:
        for m, n, fn in old:
            setattr(m, n, fn)


def _train_batch(cfg):
    """One synthetic stage-2 batch in the data source's layout (batch 1)."""
    import numpy as np

    from latentsync_tpu_torch.utils.image_processor import load_fixed_mask

    rng = np.random.default_rng(SEED + 13)
    f, res = cfg.data.num_frames, cfg.data.resolution
    gt = rng.uniform(-1, 1, (1, f, res, res, 3)).astype(np.float32)
    keep = load_fixed_mask(res)[None, None, ..., :1].astype(np.float32)
    return {"gt_pixels": gt, "masked_pixels": gt * keep,
            "ref_pixels": rng.uniform(-1, 1, (1, f, res, res, 3)).astype(np.float32),
            "masks": np.broadcast_to(keep, (1, f, res, res, 1)).copy(),
            "audio_embeds": rng.standard_normal((1, f, 50, cfg.unet.cross_attention_dim))
            .astype(np.float32),
            "mel": rng.uniform(-4, 4, (1, 80, math.ceil(f / 5 * 16), 1)).astype(np.float32)}


def _group(name: str) -> str:
    if "motion_modules." in name:
        return "motion modules"
    return "cross attentions (attn2)" if ".attn2." in name else "spatial attentions"


def check_train_step(unet, vae, device, counters):
    """Phase 11 (b): one full-width stage-2 loss and backward (weights of
    phase 3, nothing zeroed; the loss nets seeded; one batch, t and noise)
    with the kernels, against the same step with every wrapper forced to
    its plain version on the card: loss, per-group gradient rel L2, the
    share of trainable tensors with a finite non-zero gradient (must be
    100 %), the kernels' launches in the kernel run (counts set to 0 just
    before it), peak memory, the step's time and its split, and one step
    under ``torch.profiler``. Returns (launches, ok)."""
    import copy
    import dataclasses

    import torch

    from latentsync_tpu_torch.config import LatentSyncConfig
    from latentsync_tpu_torch.models.perceptual import LPIPS
    from latentsync_tpu_torch.models.syncnet import StableSyncNet
    from latentsync_tpu_torch.models.videomae import TREPALoss, VideoViT, VideoViTConfig
    from latentsync_tpu_torch.ops import _build
    from latentsync_tpu_torch.training.unet_trainer import UNetTrainer
    from latentsync_tpu_torch.utils.convert import init_random_

    bf = torch.bfloat16
    cfg = LatentSyncConfig()
    master = copy.deepcopy(unet).float().train()
    syncnet = init_random_(StableSyncNet(cfg.syncnet), seed=SEED + 4).to(device, bf)
    lpips = init_random_(LPIPS(), seed=SEED + 5).to(device, bf)
    vit = init_random_(VideoViT(VideoViTConfig(img_size=64, patch_size=16, embed_dim=64,
                                               depth=2, num_heads=4, mlp_ratio=4.0)),
                       seed=SEED + 6).to(device, bf)
    trainer = UNetTrainer(cfg, master, vae, syncnet, lpips, TREPALoss(vit), dtype=bf)
    batch = _train_batch(cfg)
    t, noise = trainer.draw(batch, 0)
    trainable = [n for n, m in trainer.mask.items() if m]

    def step():
        losses, grads = trainer.gradients(batch, t, noise)
        torch.cuda.synchronize()
        return {k: float(v.detach()) for k, v in losses.items()}, grads

    shapes = collections.Counter()

    def observe(entry, args):
        """The shape each launch of the step is given, from its arguments."""
        dims = {"ls_geglu_ffn": args[1:3], "ls_temporal_block": args[1:4],
                "ls_attn_block": args[1:4], "ls_temporal_attention": args[8:12],
                "ls_spatial_attention": args[8:12], "ls_flash_attention": args[7:11],
                "ls_flash_attention_lse": args[7:11],
                "ls_flash_attention_bwd": args[13:17]}.get(entry)
        shapes[f"{entry}{tuple(dims)}"] += 1

    with configured("default"):
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.observer = observe
        t0 = time.time()
        try:
            losses_k, grads = step()
        finally:
            _build.observer = None
        first_s = time.time() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        good_grads = [bool(torch.isfinite(grads[n]).all()) and bool(grads[n].abs().max() > 0)
                      for n in trainable]
        kept = {n: grads[n].clone() for n in trainable}
        del grads
        t0 = time.time()
        step()
        step_s = time.time() - t0
        with plain_kernels():
            losses_p, grads_p = step()
    share = sum(good_grads) / len(good_grads)
    on_path = ("geglu_ffn", "self_attention_block", "temporal_attention", "spatial_attention",
               "dot_product_attention", "flash_attention_bwd")
    ran = all(launches[n] > 0 for n in on_path)
    others = {n: v for n, v in launches.items() if n not in on_path and v}
    loss_rel = abs(losses_k["total"] - losses_p["total"]) / abs(losses_p["total"])
    groups = collections.defaultdict(lambda: [0.0, 0.0])
    for n in trainable:
        g = groups[_group(n)]
        g[0] += float((kept[n].float() - grads_p[n].float()).pow(2).sum())
        g[1] += float(grads_p[n].float().pow(2).sum())
    rels = {k: math.sqrt(d / max(r, 1e-30)) for k, (d, r) in groups.items()}
    del kept, grads_p
    ok = share == 1.0 and ran and not others and loss_rel <= UNET_TOL \
        and all(v <= GRAD_TOL for v in rels.values())
    log(f"[{gpu_line()}] train step (full width, batch 1, 16 frames, 256²): losses (kernels) "
        + ", ".join(f"{k}={v:.6g}" for k, v in losses_k.items())
        + f"; plain total={losses_p['total']:.6g}, loss rel. error {loss_rel:.3g} "
        f"(tol {UNET_TOL}); gradient rel L2 vs plain "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(rels.items()))
        + f" (tol {GRAD_TOL}); trainable tensors with a finite non-zero gradient "
        f"{sum(good_grads)}/{len(good_grads)} = {100 * share:.1f} %; launches in the kernel "
        f"run {json.dumps({n: launches[n] for n in on_path})}, other kernels {others}; peak "
        f"device memory {peak:.2f} GiB; step {step_s:.3f} s (first {first_s:.3f} s) "
        f"{'ok' if ok else 'FAIL'}")

    log("launch shapes of the step (entry point (dims) x launches): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(shapes.items())))

    # where the step's time goes: each part alone, host clock around synchronised work
    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    recon_only = UNetTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, pixel_space_supervise=False)), master, vae, dtype=bf)
    f = cfg.data.num_frames
    encode_s = timed(lambda: [trainer._encode(batch[k], 1, f)
                              for k in ("gt_pixels", "masked_pixels", "ref_pixels")])
    unet_s = timed(lambda: recon_only.gradients(batch, t, noise)) - encode_s
    z = torch.randn((f, 4, 32, 32), device=device, dtype=bf, requires_grad=True)
    decode_s = timed(lambda: torch.autograd.grad(vae.decode(z).float().mean(), z))
    pix = torch.rand((1, f, 3, 256, 256), device=device, requires_grad=True)
    mel = torch.as_tensor(batch["mel"], device=device).permute(0, 3, 1, 2).to(bf)

    def loss_nets():
        lower = pix[:, :, :, 128:]
        loss = lpips(lower.flatten(0, 1).to(bf), lower.flatten(0, 1).detach().to(bf)).mean() \
            + trainer.trepa(pix, pix.detach())
        v, a = syncnet(lower.flatten(1, 2).to(bf), mel)
        return torch.autograd.grad(loss + (v * a).sum(), pix)

    nets_s = timed(loss_nets)
    for p in master.parameters():
        p.grad = None
    log(f"[{gpu_line()}] train step split (s): VAE encode x3 (no grad) {encode_s:.4f}, UNet "
        f"forward+backward {unet_s:.4f}, VAE decode forward+backward {decode_s:.4f}, loss nets "
        f"(LPIPS, TREPA, SyncNet) forward+backward {nets_s:.4f}; parts "
        f"{encode_s + unet_s + decode_s + nets_s:.4f} of the step's {step_s:.4f}")
    n_k, dev_ms = device_busy(lambda: trainer.gradients(batch, t, noise))
    fams = collections.Counter()
    for name, us in device_kernels(lambda: trainer.gradients(batch, t, noise)):
        fams[name[:70]] += us / 1e3
    log(f"train step under torch.profiler: {n_k} device kernels, {dev_ms:.3f} device ms; "
        "largest families (ms): " + "; ".join(f"{n} {ms:.3f}" for n, ms in fams.most_common(8)))
    for p in master.parameters():
        p.grad = None
    del trainer, recon_only, master, syncnet, lpips, vit, z, pix
    torch.cuda.empty_cache()
    return launches, ok


def _write_training_clips(root: str, n: int = 2, frames: int = 60, size: int = 256):
    """Clips the data source can draw 16-frame windows from (≥ 48 frames),
    each with its .wav sidecar, and a fileslist naming them."""
    import cv2
    import numpy as np

    from latentsync_tpu_torch.utils.media import write_audio

    rng = np.random.default_rng(SEED + 14)
    paths = []
    for i in range(n):
        path = os.path.join(root, f"train{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (size, size))
        base = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        for j in range(frames):
            writer.write(np.roll(base, 3 * j, axis=1))
        writer.release()
        write_audio(path[:-4] + ".wav",
                    0.3 * rng.standard_normal(16000 * frames // 25 + 1600).astype(np.float32))
        paths.append(path)
    fileslist = os.path.join(root, "files.txt")
    with open(fileslist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return fileslist


def run_train_cli(root: str) -> bool:
    """Phase 11 (c): ``python -m latentsync_tpu_torch.scripts.train_unet`` on
    ``configs/unet_stage2.yaml`` (its ``data.train_fileslist`` pointed at the
    clips written here) for 4 steps in its own process, then one ``--resume``
    step: every step's JSON line, steps/s, peak device memory."""
    import yaml

    with open("configs/unet_stage2.yaml") as f:
        stage2 = yaml.safe_load(f)
    stage2["data"]["train_fileslist"] = _write_training_clips(root)
    config = os.path.join(root, "unet_stage2.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(stage2, f)
    out = os.path.join(root, "train_out")
    cmd = [sys.executable, "-m", "latentsync_tpu_torch.scripts.train_unet", "--config", config,
           "--output-dir", out, "--log-every", "1"]
    ok = True
    for extra, want in ((["--max-steps", "4"], [1, 2, 3, 4]),
                        (["--max-steps", "5", "--resume"], [5])):
        t0 = time.time()
        proc = subprocess.run(cmd + extra, capture_output=True, text=True, timeout=900)
        wall = time.time() - t0
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        steps = [x for x in lines if "loss" in x]
        good = proc.returncode == 0 and [x["step"] for x in steps] == want \
            and all(math.isfinite(x["loss"]) for x in steps)
        if "--resume" in extra:
            good &= bool(lines) and lines[0].get("step") == 4 and "resumed_from" in lines[0]
        ok &= good
        for x in lines:
            log(f"  train_unet: {json.dumps(x)}")
        log(f"[{gpu_line()}] train_unet {' '.join(extra)}: exit {proc.returncode}, {wall:.1f} s "
            f"in its own process, steps/s "
            f"{[round(x['steps_per_sec'], 4) for x in steps]}, peak device memory "
            f"{max([x.get('peak_memory_gib', 0) for x in steps] or [0]):.2f} GiB "
            f"{'ok' if good else 'FAIL: ' + proc.stderr[-3000:]}")
    return ok


# ---------------------------------------------------------------------------
# phase 12: face restoration
# ---------------------------------------------------------------------------

# f32 nets on the card (TF32 off) against the port on the CPU: relative L2
NET_F32_TOL = 1e-3
# CodeFormer's transformer layers at the default width: one flash launch each
CODEFORMER_LAYERS = 9


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and products without TF32 for the duration."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def timed_forwards(fn, n: int = 5):
    """(median wall ms of `n` warm calls, device ms of one call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, device_ms = device_busy(fn)
    return sorted(walls)[n // 2], device_ms


def check_codeformer(device, counters):
    """Phase 12 (a) and (b): the full-width CodeFormer (``CodeFormer()``
    defaults, seeded random non-zero weights, positions included) in bf16 at
    1 and 4 faces of 512², w = 0.5: finite, w = 0 and 1 apart, the flash
    kernel launched once a transformer layer a forward (counts set to 0
    just before); against the same weights in f32 with every wrapper forced
    to its plain version (TF32 off): the code logits within UNET_TOL in
    relative L2, the share of equal code indices printed, and the output
    given the f32 run's indices within UNET_TOL; median of 5 warm forwards
    and device ms at each batch. Then the full-width VQAutoEncoder: finite,
    timed. Returns (flash launches of one forward at B = 4, ok)."""
    import copy

    import torch

    from latentsync_tpu_torch.models import codeformer as cf
    from latentsync_tpu_torch.ops import attention
    from latentsync_tpu_torch.utils.convert import init_random_

    ok = True
    gen = torch.Generator().manual_seed(SEED + 12)
    model = init_random_(cf.CodeFormer(), seed=SEED + 12).eval()
    ok &= bool(model.position_emb.abs().min() > 0)
    ref_model = copy.deepcopy(model).to(device)
    model = cf.cast_floating_(model, torch.bfloat16).to(device)
    faces = (torch.rand((4, 3, 512, 512), generator=gen) * 2 - 1).to(device)
    launches = 0
    with torch.no_grad():
        for b in (1, 4):
            x = faces[:b]
            for fn in counters:
                fn.launches = 0
            out, logits, lq = model(x, w=0.5)
            torch.cuda.synchronize()
            n_flash = attention.dot_product_attention.launches
            others = {fn.__name__: fn.launches for fn in counters
                      if fn is not attention.dot_product_attention and fn.launches}
            if b == 4:
                launches = n_flash
            zero, _, _ = model(x, w=0.0)
            one, _, _ = model(x, w=1.0)
            finite = bool(torch.isfinite(out).all() and torch.isfinite(logits).all())
            apart = not torch.equal(zero, one)
            with plain_kernels(), no_tf32():
                ref_out, ref_logits, _ = ref_model(x, w=0.5)
            ref_idx = ref_logits.argmax(-1)
            logits_err = _rel_l2(logits.float(), ref_logits)
            agree = float((logits.argmax(-1) == ref_idx).float().mean())
            lookup = model.quantize.codebook_lookup
            model.quantize.codebook_lookup = lambda idx, shape: lookup(ref_idx, shape)
            try:  # the generator on the f32 run's codes
                held, _, _ = model(x, w=0.5)
            finally:
                model.quantize.codebook_lookup = lookup
            out_err = _rel_l2(held.float(), ref_out)
            wall_ms, device_ms = timed_forwards(lambda: model(x, w=0.5))
            good = (finite and apart and n_flash == CODEFORMER_LAYERS and not others
                    and logits_err <= UNET_TOL and out_err <= UNET_TOL
                    and tuple(out.shape) == (b, 3, 512, 512))
            ok &= good
            log(f"codeformer B={b}: out {tuple(out.shape)} finite={finite} w0_vs_w1_apart={apart} "
                f"flash_launches={n_flash} (want {CODEFORMER_LAYERS}) other_kernels={others} "
                f"logits_rel_l2={logits_err:.5f} equal_codes={agree:.4f} "
                f"out_rel_l2_on_f32_codes={out_err:.5f} tol={UNET_TOL} "
                f"median_ms={wall_ms:.2f} device_ms={device_ms:.2f} {'ok' if good else 'FAIL'}")
    del model, ref_model
    torch.cuda.empty_cache()

    vq = cf.cast_floating_(init_random_(cf.VQAutoEncoder(), seed=SEED + 13).eval(),
                           torch.bfloat16).to(device)
    with torch.no_grad():
        rec, _, idx = vq(faces)
        finite = bool(torch.isfinite(rec).all())
        wall_ms, device_ms = timed_forwards(lambda: vq(faces))
    good = finite and tuple(rec.shape) == (4, 3, 512, 512) and tuple(idx.shape) == (4, 16, 16)
    ok &= good
    log(f"vqgan autoencoder B=4: rec {tuple(rec.shape)} finite={finite} median_ms={wall_ms:.2f} "
        f"device_ms={device_ms:.2f} {'ok' if good else 'FAIL'}")
    del vq
    torch.cuda.empty_cache()
    return launches, ok


def randomize_bn_(module, seed: int):
    """Batch norms with seeded statistics and affine terms (scale 1 + N(0,
    0.1²), shift N(0, 0.02²), running mean N(0, 0.1²), running variance 1 +
    |N(0, 0.3²)|): ``init_random_`` treats a 1-D tensor as a bias."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.02 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(1 + (0.3 * torch.randn(n, generator=gen)).abs())
    return module


def check_restoration_nets(device) -> bool:
    """Phase 12 (c): the detectors, parsers and the upsampler's net on the
    card against the port on the CPU, one small image each, seeded random
    weights: RetinaFace (mobile0.25, resnet50), YOLOv5-face (n, l), ParseNet
    and BiSeNet in f32 with TF32 off (within NET_F32_TOL in relative L2 of
    all outputs), RRDBNet x2 in bf16, the dtype ``RealESRGANUpsampler``
    runs it in (within UNET_TOL of the f32 CPU run)."""
    import copy

    import torch

    from latentsync_tpu_torch.models.parsing import BiSeNet, ParseNet
    from latentsync_tpu_torch.models.retinaface import RetinaFace
    from latentsync_tpu_torch.models.rrdbnet import RRDBNet
    from latentsync_tpu_torch.models.yolov5face import YOLOv5Face
    from latentsync_tpu_torch.utils.convert import init_random_

    gen = torch.Generator().manual_seed(SEED + 14)
    bgr = torch.randn((1, 3, 160, 160), generator=gen) * 60
    rgb01 = torch.rand((1, 3, 128, 128), generator=gen)
    face = torch.rand((1, 3, 128, 128), generator=gen) * 2 - 1
    nets = [("retinaface mobile0.25", lambda: RetinaFace("mobile0.25"), bgr, torch.float32),
            ("retinaface resnet50", lambda: RetinaFace("resnet50"), bgr, torch.float32),
            ("yolov5n-face", lambda: YOLOv5Face("yolov5n"), rgb01, torch.float32),
            ("yolov5l-face", lambda: YOLOv5Face("yolov5l"), rgb01, torch.float32),
            ("parsenet", ParseNet, face, torch.float32),
            ("bisenet", BiSeNet, face, torch.float32),
            ("rrdbnet x2", lambda: RRDBNet(scale=2), rgb01[..., :64, :64], torch.bfloat16)]
    ok = True
    for i, (name, make, x, dtype) in enumerate(nets):
        cpu = randomize_bn_(init_random_(make(), seed=SEED + 20 + i), SEED + 40 + i).eval()
        card = copy.deepcopy(cpu).to(device, dtype)
        with torch.no_grad(), no_tf32():
            ref = [t.float() for t in _tensors(cpu(x))]
            t0 = time.time()
            got = [t.float().cpu() for t in _tensors(card(x.to(device)))]
            torch.cuda.synchronize()
            card_s = time.time() - t0
        err = _rel_l2(torch.cat([t.flatten() for t in got]), torch.cat([t.flatten() for t in ref]))
        tol = NET_F32_TOL if dtype == torch.float32 else UNET_TOL
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        good = finite and err <= tol and [t.shape for t in got] == [t.shape for t in ref]
        ok &= good
        log(f"restoration net {name:22s} {str(dtype).split('.')[-1]} card vs CPU rel_l2={err:.3g} "
            f"tol={tol} outputs={len(got)} first_call_s={card_s:.2f} {'ok' if good else 'FAIL'}")
    return ok


def _write_faces(root: str, n: int, hw) -> list:
    """n synthetic faces (a skin ellipse, eyes and a mouth on a gradient)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(SEED)
    h, w = hw
    paths = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[:] = np.linspace(40, 200, w, dtype=np.uint8)[None, :, None]
        cx, cy, r = w // 2 + 20 * i, h // 2, min(h, w) // 4
        cv2.ellipse(img, (cx, cy), (int(r * 0.8), r), 0, 0, 360, (140, 160, 200), -1)
        for dx in (-0.35, 0.35):
            cv2.circle(img, (int(cx + dx * r), int(cy - 0.2 * r)), max(r // 10, 2), (40, 30, 30),
                       -1)
        cv2.ellipse(img, (cx, int(cy + 0.45 * r)), (r // 3, r // 10), 0, 0, 360, (60, 60, 150),
                    -1)
        img = cv2.add(img, rng.integers(0, 10, img.shape, dtype=np.uint8))
        path = os.path.join(root, f"face{i}.png")
        cv2.imwrite(path, img)
        paths.append(path)
    return paths


def run_restoration_clis(root: str) -> bool:
    """Phase 12 (d): the restoration CLIs in subprocesses on the card (seeded
    random weights: no checkpoint files): ``inference_codeformer`` on two
    synthetic 720p PNGs and an 8-frame ``.mp4``, ``inference_vqgan`` and
    ``crop_align_face``; each exits 0 and writes outputs of the expected
    shapes."""
    import cv2

    src = os.path.join(root, "faces")
    os.makedirs(src)
    paths = _write_faces(src, 2, (720, 1280))
    video = os.path.join(root, "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25, (640, 360))
    for i in range(8):
        writer.write(cv2.resize(cv2.imread(paths[i % 2]), (640, 360)))
    writer.release()
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "none.pth")

    def run(module, *args):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", f"latentsync_tpu_torch.scripts.{module}",
                               *args, "--device", "cuda"], capture_output=True, text=True,
                              timeout=600, cwd=here)
        if proc.returncode:
            log(proc.stderr[-3000:])
        return proc.returncode, time.time() - t0

    def shape(path):
        img = cv2.imread(path)
        return None if img is None else img.shape

    ok = True
    out = os.path.join(root, "restored")
    rc, wall = run("inference_codeformer", "--input", src, "--out", out, "--ckpt", ckpt)
    shapes = [shape(os.path.join(out, os.path.basename(p))) for p in paths]
    good = rc == 0 and shapes == [(720, 1280, 3)] * 2
    rc_v, wall_v = run("inference_codeformer", "--input", video, "--out", out, "-w", "0.7",
                       "--ckpt", ckpt)
    cap = cv2.VideoCapture(os.path.join(out, "clip.mp4"))
    frames = []
    while True:
        read, fr = cap.read()
        if not read:
            break
        frames.append(fr.shape)
    cap.release()
    good_v = rc_v == 0 and frames == [(360, 640, 3)] * 8
    log(f"inference_codeformer CLI: 2 PNGs rc={rc} shapes={shapes} wall_s={wall:.1f}; 8-frame "
        f"mp4 rc={rc_v} frames={len(frames)} wall_s={wall_v:.1f} "
        f"{'ok' if good and good_v else 'FAIL'}")
    ok &= good and good_v
    rec = os.path.join(root, "rec")
    rc, wall = run("inference_vqgan", "-i", src, "-o", rec, "--ckpt_path", ckpt)
    shapes = [shape(os.path.join(rec, f"face{i}_rec.png")) for i in range(2)]
    good = rc == 0 and shapes == [(512, 512, 3)] * 2
    ok &= good
    log(f"inference_vqgan CLI: rc={rc} shapes={shapes} wall_s={wall:.1f} {'ok' if good else 'FAIL'}")
    aligned = os.path.join(root, "aligned")
    rc, wall = run("crop_align_face", "-i", src, "-o", aligned, "--output_size", "256",
                   "--transform_size", "1024")
    shapes = [shape(os.path.join(aligned, f"face{i}.png")) for i in range(2)]
    good = rc == 0 and shapes == [(256, 256, 3)] * 2
    ok &= good
    log(f"crop_align_face CLI: rc={rc} shapes={shapes} wall_s={wall:.1f} {'ok' if good else 'FAIL'}")
    return ok


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
                attention.flash_attention, attention.flash_attention_bwd]
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
        phase = "flash backward"
        bwd_entry, good = check_flash_backward(device)
        ok &= good
        log(f"phase 2 (the flash route's backward kernels vs their plain version): "
            f"{'ok' if good else 'FAIL'}")

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
            short, long_ = ("1.2s", 32), ("2.4s", 64)
            for number, conf, plan in ((4, "default", [short, long_, short]),
                                       (5, "fused", [short, long_]),
                                       (6, "int8", [short, long_]),
                                       (6, "int8-dense", [short, long_])):
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
        phase = "production point"
        good = check_deepcache(unet, device, counters)
        good &= run_dcread(unet, device)
        good &= time_denoise(pipeline, device, counters)
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            _, served = serve_production(pipeline, root, counters)
            good &= served
            good &= check_pipelined(pipeline, root, audios)
            good &= run_cli(root, audios)
        ok &= good
        log(f"phase 9 (the production serving point: DeepCache paths, dcread, a window batch's "
            f"denoise, three requests continuous-batched at int8 + 4:1:enc + 0:0.5, "
            f"run_pipelined, the inference CLI): {'ok' if good else 'FAIL'}")
        phase = "restore, transcription and the worker"
        t0 = time.time()
        good = check_transport(device)
        good &= check_device_restore(device)
        with tempfile.TemporaryDirectory() as root:
            audios = make_avatar(root)
            good &= serve_both_routes(pipeline, root, audios)
            transcribed, transcriber = check_transcription(device, root)
            good &= transcribed
            good &= run_worker(pipeline, root, audios, transcriber)
        ok &= good
        log(f"phase 10 (device restore against its CPU run, one request on both restore routes, "
            f"whisper-tiny transcription on the card, the job-queue worker; {time.time() - t0:.0f}"
            f" s): {'ok' if good else 'FAIL'}")
        phase = "training"
        t0 = time.time()
        good = check_function_grads(device)
        train_launches, trained = check_train_step(unet, vae, device, counters)
        good &= trained
        with tempfile.TemporaryDirectory() as root:
            good &= run_train_cli(root)
        ok &= good
        log(f"phase 11 (stage-2 training on the card: the kernels' "
            f"gradients, a full-width loss and backward against the plain versions, the "
            f"training CLI for 4 steps and a resumed one; {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        phase = "face restoration"
        t0 = time.time()
        restore_launches, good = check_codeformer(device, counters)
        good &= check_restoration_nets(device)
        with tempfile.TemporaryDirectory() as root:
            good &= run_restoration_clis(root)
        ok &= good
        log(f"phase 12 (face restoration: full-width CodeFormer at 1 and 4 faces against its "
            f"f32 plain run, the VQGAN autoencoder, the detectors, parsers and upsampler net "
            f"against the CPU, the restoration CLIs; {time.time() - t0:.0f} s): "
            f"{'ok' if good else 'FAIL'}")
        for k in kernels:
            if k.get("path") == "codeformer":
                k["launches"] = restore_launches
                continue
            if k["name"] in PROBE_PATH:
                k["path"], k["launches"] = PROBE_PATH[k["name"]], probe_launches[k["name"]]
                continue
            k["path"] = next(conf for conf in CONFIGS if k["name"] in ON_PATH[conf])
            k["launches"] = launches[k["path"]][k["name"]]
        bwd_entry["path"], bwd_entry["launches"] = "train", train_launches["flash_attention_bwd"]
        kernels.append(bwd_entry)
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
