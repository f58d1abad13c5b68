"""Device-time profile of one warm UNet forward, kernel by kernel.

    python -m latentsync_tpu_torch.scripts.profile_forward [--config default] [--w 2]

Builds the full-width LatentSync 1.5 stage-2 UNet with random seeded
weights, runs warm-up forwards at batch 2·w (w windows × CFG 2, 16 frames),
then one forward under ``torch.profiler`` and prints, as JSON lines: the
card's name and power limit, the sum of device kernel time by family (the
hand kernels by their names, the library's by what they do), the forward's
span on the device (first kernel start to last kernel end), the share of the
span in which a kernel ran (the rest is the device waiting for the host) and
the largest kernels by name. ``--config`` names the served configuration
(``default``, ``fused``, ``int8``, ``int8-dense``), i.e. the reference's
switches. ``--device cpu`` profiles host operators at whatever config it is
given (the tests' use): its lines carry ``cpu_ms`` and no device metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import torch

from ..config import LatentSyncConfig
from .micro_probe import gpu_line

CONFIGS = {
    "default": {},
    "fused": {"LATENTSYNC_PALLAS_GN": "1", "LATENTSYNC_FUSED_XATTN": "1"},
    "int8": {"LATENTSYNC_INT8": "1"},
    "int8-dense": {"LATENTSYNC_INT8": "1", "LATENTSYNC_INT8_DENSE": "pallas"},
}
# family → substrings of a device kernel's name, first match wins
FAMILIES = [
    # K8: its row pass, and the GEMM template's int8 mode (E = signed char)
    ("k8_qmm", ("qmm", "signed char>(ls_gemm")),
    # K5's core: the attention core with K11's numerics (P_NORMALISED = 1),
    # which no other kernel of a forward runs
    ("k5_cross_core", tuple(f"attn_kernel<{d}, {nwg}, 1," for d in (40, 80) for nwg in (1, 2))),
    # K2 in temporal mode: one kernel, its products and core inside
    ("k2_temporal_block", ("temporal_block",)),
    # K2's spatial core: the attention core instantiated for K2 alone
    ("k2_spatial_core", ("k2_spatial_core",)),
    ("gemm_template", ("ls_gemm", "gemm_kernel", "row_stats", "ln_rows", "qkv_kernel")),
    ("k4_spatial_core", ("ls_core", "attn_kernel", "spatial_kernel")),
    ("k3_temporal_core", ("temporal",)),
    ("groupnorm_kernels", ("gn_", "group_norm_silu")),
    ("flash", ("flash",)),
    ("library_convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "nchw", "nhwc")),
    ("library_matmul", ("cutlass", "cublas", "xmma", "gemv", "gemm", "splitk", "int_mm")),
    ("layout_copies_casts", ("copy", "cat", "transpose", "permute", "fill", "index", "gather")),
    ("norms_reductions", ("reduce", "norm", "softmax", "welford", "mean", "var")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def family_of(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def _busy(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_forward(device, conf: str = "default", w: int = 2,
                    cfg: Optional[LatentSyncConfig] = None, warmup: int = 3, top: int = 25,
                    emit=lambda rec: print(json.dumps(rec), flush=True)):
    from torch.profiler import ProfilerActivity, profile

    from ..models.unet3d import UNet3DConditionModel
    from ..utils.convert import init_random_

    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = cfg or LatentSyncConfig()
    dtype = torch.bfloat16 if on_card else torch.float32
    unet = init_random_(UNet3DConditionModel(cfg.unet), seed=0).to(device, dtype).eval()
    gen = torch.Generator().manual_seed(0)
    b, f = 2 * w, cfg.data.num_frames
    lat = cfg.data.resolution // cfg.vae.scale_factor
    x = torch.randn((b, cfg.unet.in_channels, f, lat, lat), generator=gen).to(device, dtype)
    audio = torch.randn((b, f, 50, cfg.unet.cross_attention_dim), generator=gen).to(device, dtype)
    t = torch.full((b,), 501, device=device)
    old = {k: os.environ.get(k) for env in CONFIGS.values() for k in env}
    for k in old:
        os.environ.pop(k, None)
    os.environ.update(CONFIGS[conf])
    try:
        with torch.inference_mode():
            for _ in range(warmup):
                unet(x, t, audio)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            if on_card:
                torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                unet(x, t, audio)
                if on_card:
                    torch.cuda.synchronize()
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if not on_card:
        total = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3
        emit({"name": f"forward_{conf}_b{b}", "device": "cpu", "cpu_ms": total})
        return prof
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_family, intervals = {}, {}, []
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        intervals.append((e.time_range.start / 1e3, e.time_range.end / 1e3))
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + ms)
        n, tot = by_family.get(family_of(e.name), (0, 0.0))
        by_family[family_of(e.name)] = (n + 1, tot + ms)
    if not intervals:
        raise RuntimeError("profile_forward: the profiler recorded no device kernel")
    span = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _busy(intervals)
    emit({"name": f"forward_{conf}_b{b}", "device_span_ms": span, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / span, "kernel_sum_ms": sum(v for _, v in by_name.values()),
          "kernels": len(kernels)})
    for fam, (n, ms) in sorted(by_family.items(), key=lambda kv: -kv[1][1]):
        emit({"family": fam, "launches": n, "device_ms": ms, "share_of_busy": ms / busy})
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        emit({"kernel": name[:120], "family": family_of(name), "launches": n, "device_ms": ms})
    return prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--w", type=int, default=2, help="windows (batch = 2·w)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_forward: no CUDA device (torch.cuda.is_available() is false)",
                  file=sys.stderr)
            return 2
        print(gpu_line(), flush=True)
    profile_forward(device, args.config, args.w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
