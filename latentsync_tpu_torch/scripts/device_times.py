"""Device time of single kernels from ``torch.profiler``, beside their bounds.

    python -m latentsync_tpu_torch.scripts.device_times [--which k3,k6,k10,bwd,fwd,d64] [--calls 20]

Times K3 (``temporal_attention``) at its four served shapes (the default
and fused forwards' C = 1280 blocks at batch 4 and 1, the int8-dense
forward's composed blocks at C = 320 and 640) and at F = 8 and 24 frames,
K6 (``group_norm_silu``) at every shape one fused forward gives it
(``--which k6`` builds the full-width UNet once and counts its launches by
shape) and K10 (``geglu_ffn_int8io``) at the probe's three shapes. For each: ``--calls``
calls under ``torch.profiler`` after two warm-ups; ``device_ms`` is the
device time of the port's kernels (every device kernel whose name is not
``at::...``) over the calls, ``kernels_a_call`` their count over the calls,
``library_device_ms`` the same for the one PyTorch call of the function
(SDPA for K3, ``F.group_norm`` (+ ``F.silu``) for K6, dequantization, the
``F.linear`` GEGLU and row quantization for K10: timed here, used nowhere
in the port); ``bound_ms`` each input read once and each output written
once over 3.35 TB/s, or the operations over the card's peak for their type,
the larger, and ``share`` = bound / device. For K6 the last line sums
launches x device time and launches x bound over the forward.

``--which bwd`` times the flash route's backward (``flash_attention_bwd``)
at the three shapes of a UNet train step and CodeFormer's two (D = 64 at
4 faces and 1, its stage-II training), with the device time of each of its
kernels by name, beside its plain version and SDPA's backward (from one
forward graph kept for repeated backwards); the backward takes the residual
forward's (``flash_attention_fwd``) o and lse, as the train step does, and
the residual forward is timed beside the forward without grad. The
backward's bound counts the function's own bytes, q, k, v and do read and
dq, dk and dv written, not the residuals of this design. ``--which fwd``
times the attention kernels that share the attention core with the flash
route, at their phase-2 shapes, without grad: the flash route itself, K4,
K5 (``LATENTSYNC_FUSED_XATTN=1``), K11 and K12. ``--which d64`` times the
flash route at CodeFormer's head dim 64 ((B, 256, 8, 64) at 1 and 4 faces)
beside its plain version, SDPA on the same inputs and its bound.

The first line is the card's name and power limit; then one JSON line a
measurement. It calls only the public wrappers, so the same file run from
another checkout of the port times that checkout's kernels (two trees in
one call compare on one card); ``--which bwd`` needs ``flash_attention_fwd``,
so a checkout without it is timed by its own copy of this file.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys

import torch
import torch.nn.functional as F

from ..ops import attention, attn_block, ffn
from ..ops import groupnorm as gn
from ..ops import temporal_attention as ta
from .micro_probe import gpu_line

MEM_RATE = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
# (B, F, heads * D) of K3 with 8 heads: default / fused at C = 1280 (batch 4
# and the 1-window batch), int8-dense's composed blocks at C = 320 and 640;
# then windows of 8 and 24 frames (one row tile with keys masked, two tiles)
K3_SHAPES = [(256, 16, 1280), (64, 16, 1280), (4096, 16, 320), (1024, 16, 640),
             (256, 8, 1280), (256, 24, 1280), (4096, 24, 320)]
K10_SHAPES = [(131072, 320), (32768, 640), (8192, 1280)]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(nbytes: int, ops: float, kind: str):
    by_bytes, by_ops = nbytes / MEM_RATE * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_ms(fn, calls: int, port_only: bool, attempts: int = 3):
    """(device ms a call, device kernels a call) of `fn` over `calls` calls
    under the profiler; `port_only` counts only kernels not named at::. A
    trace with no device kernel lost its events (it happens on the card now
    and then): it is taken again, up to `attempts` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    evs = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not (port_only and "at::" in e.name)]
        if evs:
            break
    if not evs:
        raise RuntimeError("device_times: the profiler recorded no device kernel")
    total = sum((e.time_range.end - e.time_range.start) for e in evs) / 1e3
    return total / calls, len(evs) / calls


def device_by_name(fn, calls: int) -> dict:
    """{kernel name: device ms a call} of `fn` over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name[:80]] += (e.time_range.end - e.time_range.start) / 1e3 / calls
    return dict(out)


def _emit(rec):
    print(json.dumps(rec), flush=True)


def time_k3(r, calls: int) -> None:
    for b, f, hd in K3_SHAPES:
        q, k, v = r(b, f, hd), r(b, f, hd), r(b, f, hd)
        ms, n = device_ms(lambda: ta.temporal_attention(q, k, v, 8), calls, True)

        def sdpa():
            qh, kh, vh = (t.reshape(b, f, 8, hd // 8).transpose(1, 2) for t in (q, k, v))
            return F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(b, f, hd)

        lib, _ = device_ms(sdpa, calls, False)
        bd, by = bound_ms(4 * _nbytes(q), 4 * b * f * f * hd, "bf16")
        _emit({"kernel": "temporal_attention", "shape": [b, f, hd], "device_ms": ms,
               "kernels_a_call": n, "library_device_ms": lib, "bound_ms": bd, "bound_by": by,
               "share": bd / ms})


def gn_forward_shapes():
    """{((N, C, *spatial), eps, silu): launches} of K6 in one fused forward
    of the full-width UNet at batch 4 (2 windows x CFG 2)."""
    from ..config import LatentSyncConfig
    from ..models import unet3d
    from ..utils.convert import init_random_

    cfg = LatentSyncConfig()
    unet = init_random_(unet3d.UNet3DConditionModel(cfg.unet), seed=0).to("cuda",
                                                                          torch.bfloat16).eval()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, cfg.unet.in_channels, 16, 32, 32), generator=gen).to("cuda",
                                                                             torch.bfloat16)
    audio = torch.randn((4, 16, 50, cfg.unet.cross_attention_dim), generator=gen).to(
        "cuda", torch.bfloat16)
    t = torch.full((4,), 501, device="cuda")
    seen = collections.Counter()
    auto = unet3d.group_norm_silu_auto

    def spy(x, scale, bias, groups, eps=1e-5, silu=True):
        if gn.gn_route(math.prod(x.shape[2:]), x.shape[1]) == "single":
            seen[(tuple(x.shape), eps, silu)] += 1
        return auto(x, scale, bias, groups, eps, silu)

    old = {k: os.environ.get(k) for k in ("LATENTSYNC_PALLAS_GN", "LATENTSYNC_FUSED_XATTN")}
    os.environ.update({k: "1" for k in old})
    unet3d.group_norm_silu_auto = spy
    try:
        with torch.inference_mode():
            unet(x, t, audio)
    finally:
        unet3d.group_norm_silu_auto = auto
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    del unet
    torch.cuda.empty_cache()
    return seen


def time_k6(r, calls: int) -> None:
    shapes = gn_forward_shapes()
    sum_dev = sum_bound = 0.0
    for (shape, eps, silu), launches in sorted(shapes.items()):
        c = shape[1]
        x, scale, bias = r(*shape) * 2 + 0.5, 1 + r(c, s=0.1), r(c, s=0.1)
        ms, n = device_ms(lambda: gn.group_norm_silu(x, scale, bias, 32, eps=eps, silu=silu),
                          calls, True)

        def library():
            y = F.group_norm(x, 32, scale, bias, eps)
            return F.silu(y) if silu else y

        lib, _ = device_ms(library, calls, False)
        bd, by = bound_ms(2 * _nbytes(x) + _nbytes(scale, bias), 10 * x.numel(), "f32")
        sum_dev += launches * ms
        sum_bound += launches * bd
        _emit({"kernel": "group_norm_silu", "shape": list(shape), "eps": eps, "silu": silu,
               "launches_a_fused_forward": launches, "device_ms": ms, "kernels_a_call": n,
               "library_device_ms": lib, "bound_ms": bd, "bound_by": by, "share": bd / ms})
    _emit({"kernel": "group_norm_silu", "fused_forward_launches": sum(shapes.values()),
           "device_ms_sum": sum_dev, "bound_ms_sum": sum_bound, "share": sum_bound / sum_dev})


def time_k10(r, calls: int) -> None:
    for m, c in K10_SHAPES:
        args = (*ffn.quantize_rowwise(r(m, c)), r(8 * c, c, s=c**-0.5), r(8 * c, s=0.1).float(),
                r(c, 4 * c, s=(4 * c) ** -0.5), r(c, s=0.1).float())
        ms, n = device_ms(lambda: ffn.geglu_ffn_int8io(*args), calls, True)
        codes, scales, w_up, b_up, w_dn, b_dn = args

        def library():
            x = (codes.float() * scales).to(w_up.dtype)
            value, gate = F.linear(x, w_up, b_up.to(x.dtype)).chunk(2, dim=-1)
            return ffn.quantize_rowwise(F.linear(value * F.gelu(gate), w_dn, b_dn.to(x.dtype)))

        lib, _ = device_ms(library, calls, False)
        out = ffn.geglu_ffn_int8io(*args)
        bd, by = bound_ms(_nbytes(*args, *out), 24 * m * c * c, "bf16")
        _emit({"kernel": "geglu_ffn_int8io", "shape": [m, c], "device_ms": ms,
               "kernels_a_call": n, "library_device_ms": lib, "bound_ms": bd, "bound_by": by,
               "share": bd / ms})


FLASH_BWD_SHAPES = [(16, 1024, 1, 512), (16, 1024, 8, 40), (16, 256, 8, 80), (4, 256, 8, 64),
                    (1, 256, 8, 64)]


def time_bwd(r, calls: int) -> None:
    for b, s, h, d in FLASH_BWD_SHAPES:
        q, k, v, do = (r(b, s, h, d) for _ in range(4))
        scale = d**-0.5
        rec = {"kernel": "flash_attention_bwd", "shape": [b, s, h, d]}
        o, lse = attention.flash_attention_fwd(q, k, v, scale)

        def bwd():
            return attention.flash_attention_bwd(q, k, v, do, scale, o=o, lse=lse)

        with torch.no_grad():
            rec["residual_forward_device_ms"] = device_ms(
                lambda: attention.flash_attention_fwd(q, k, v, scale), calls, True)[0]
            rec["forward_without_grad_device_ms"] = device_ms(
                lambda: attention.dot_product_attention(q, k, v, scale), calls, True)[0]
        rec["without_residuals_device_ms"] = device_ms(
            lambda: attention.flash_attention_bwd(q, k, v, do, scale), calls, True)[0]
        rec["device_ms"], rec["kernels_a_call"] = device_ms(bwd, calls, True)
        rec["by_kernel_ms"] = device_by_name(bwd, calls)
        rec["plain_device_ms"] = device_ms(
            lambda: attention.flash_attention_bwd_reference(q, k, v, do, scale), calls, False)[0]
        qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        dot = do.transpose(1, 2)
        rec["library_device_ms"] = device_ms(
            lambda: torch.autograd.grad(out, (qs, ks, vs), dot, retain_graph=True), calls,
            False)[0]
        # the function's bytes: q, k, v, do in, dq, dk, dv out
        bd, by = bound_ms(7 * _nbytes(q), 10 * b * h * s * s * d, "bf16")
        rec.update(bound_ms=bd, bound_by=by, share=bd / rec["device_ms"])
        _emit(rec)


def time_fwd(r, calls: int) -> None:
    def emit(name, shape, fn):
        ms, n = device_ms(fn, calls, True)
        _emit({"kernel": name, "shape": shape, "device_ms": ms, "kernels_a_call": n})

    for b, s, h, d in [(64, 1024, 1, 512), (16, 1024, 1, 512), (16, 1024, 8, 40),
                       (16, 256, 8, 80)]:
        q, k, v = (r(b, s, h, d) for _ in range(3))
        emit("dot_product_attention", [b, s, h, d],
             lambda: attention.dot_product_attention(q, k, v))
    q, k, v = (r(64, 1024, 320) for _ in range(3))
    emit("spatial_attention", [64, 1024, 320], lambda: ta.spatial_attention(q, k, v, 8))
    c = 320
    args = (r(64, 1024, c), 1 + r(c, s=0.1), r(c, s=0.1), r(64, 50, 384), r(c, c, s=c**-0.5),
            r(c, 384, s=384**-0.5), r(c, 384, s=384**-0.5), r(c, c, s=c**-0.5), r(c, s=0.1), 8)
    old = os.environ.get("LATENTSYNC_FUSED_XATTN")
    os.environ["LATENTSYNC_FUSED_XATTN"] = "1"  # K5 launches only so
    try:
        emit("cross_attention_block", [64, 1024, c],
             lambda: attn_block.cross_attention_block(*args))
    finally:
        os.environ.pop("LATENTSYNC_FUSED_XATTN")
        if old is not None:
            os.environ["LATENTSYNC_FUSED_XATTN"] = old
    q, k, v = (r(1024, 1024, 40) for _ in range(3))
    emit("oneshot_attention", [1024, 1024, 40], lambda: attention.oneshot_attention(q, k, v))
    q, k, v = (r(64, 1024, 512) for _ in range(3))
    emit("flash_attention", [64, 1024, 512], lambda: attention.flash_attention(q, k, v))


CODEFORMER_SHAPES = [(1, 256, 8, 64), (4, 256, 8, 64)]


def time_d64(r, calls: int) -> None:
    """The flash route at D = 64 (CodeFormer's transformer) by device time,
    beside the plain version's and SDPA's; bound: q, k, v read and o
    written, against 4 B H S² D operations in bf16."""
    for b, s, h, d in CODEFORMER_SHAPES:
        q, k, v = (r(b, s, h, d) for _ in range(3))
        ms, n = device_ms(lambda: attention.dot_product_attention(q, k, v), calls, True)
        plain_ms, _ = device_ms(lambda: attention.dot_product_attention_reference(q, k, v),
                                calls, False)
        lib_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), calls, False)
        bound, by = bound_ms(_nbytes(q, k, v, q), 4 * b * h * s * s * d, "bf16")
        _emit({"kernel": "dot_product_attention", "shape": [b, s, h, d], "device_ms": ms,
               "kernels_a_call": n, "plain_device_ms": plain_ms, "library_device_ms": lib_ms,
               "bound_ms": bound, "bound_by": by, "share": bound / ms})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="k3,k6,k10",
                    help="any of k3, k6, k10, bwd, fwd, d64, comma-separated")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("device_times: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(gpu_line(), flush=True)
    gen = torch.Generator().manual_seed(0)

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda", torch.bfloat16)

    which = set(args.which.split(","))
    if "bwd" in which:  # autograd: the plain version's and SDPA's backward
        time_bwd(r, args.calls)
    with torch.inference_mode():
        if "fwd" in which:
            time_fwd(r, args.calls)
        if "d64" in which:
            time_d64(r, args.calls)
        if "k3" in which:
            time_k3(r, args.calls)
        if "k10" in which:
            time_k10(r, args.calls)
        if "k6" in which:
            time_k6(r, args.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
