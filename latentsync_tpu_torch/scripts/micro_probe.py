"""Micro-benchmarks of the denoise hot path, op by op, on one NVIDIA GPU.

Counterpart of ``scripts/micro_probe.py``: the same ``--which`` modes at
the same full-width shapes of LatentSync 1.5 stage 2 (``--w`` windows,
CFG-batched: bf = 2·w·16 frames), with each TPU kernel's place taken by the
port's hand-written Hopper kernel. Where the reference A/Bs a Pallas kernel
against its XLA lowering, this A/Bs the hand kernel against the one PyTorch
library call that computes the same function
(``F.scaled_dot_product_attention``, ``F.group_norm``, ``F.linear``), or
against the plain composition where there is no such call. The library
calls are timed here and used nowhere in the port.

    python -m latentsync_tpu_torch.scripts.micro_probe --which ffn [--w 4] [--iters 20]

The first line printed is the card's name and power limit as ``nvidia-smi``
gives them; then one JSON line per measurement: ``name``, ``ms`` (CUDA
events around ``--iters`` chained applications after a warm-up: each output
feeds the next call), ``gflops`` (counted from the shapes) and the share of
the card's published dense peak the line names: 989e12 bf16 FLOP/s or
1,979e12 int8 OP/s (NVIDIA H100 SXM). ``--device cpu`` runs the plain
versions on the CPU at whatever shapes it is given (the tests' use): its
lines carry ``cpu_ms`` and no share, since a CPU time is no device metric.

Modes: attn, spat, conv, gn, gn2, gn3, int8, ffn, ffn8, qmm, unet, ablate,
tmod, denoise, vae, and all (every one of these). Not ported yet, and
raising ``NotImplementedError``: dcread (needs DeepCache), spatq and tempq
(they sweep TPU block sizes the Hopper kernels do not take).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LatentSyncConfig
from ..ops import _build, attention, ffn, qconv, qmm
from ..ops import groupnorm as gn
from ..ops import temporal_attention as ta

# published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet)
PEAKS = {"bf16": 989e12, "int8": 1979e12}
SHARE_KEYS = {"bf16": "share_of_bf16_peak_989e12", "int8": "share_of_int8_peak_1979e12"}
UNPORTED = {
    "dcread": "ROADMAP §1.4 (DeepCache and the CFG interval)",
    "spatq": "ROADMAP §1.12 (block-size sweeps return with the redesign of K4)",
    "tempq": "ROADMAP §1.12 (block-size sweeps return with the redesign of K3)",
}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Probe:
    """Device, sizes and the seeded inputs of one probe run; `emit` takes
    each measurement (a dict) and prints it as one JSON line."""

    def __init__(self, device="cuda", w: int = 4, iters: int = 20,
                 emit: Optional[Callable] = None):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.w = w
        self.bf = 2 * w * 16  # CFG-batched frame count
        self.iters = iters
        self.warmup = 2 if self.on_card else 1
        self.dtype = torch.bfloat16 if self.on_card else torch.float32
        self.rng = np.random.default_rng(0)
        self.results = []
        self._emit = emit or (lambda rec: print(json.dumps(rec), flush=True))

    def randn(self, *shape, s: float = 1.0, dtype=None) -> torch.Tensor:
        a = self.rng.standard_normal(shape, dtype=np.float32) * s
        return torch.from_numpy(a).to(self.device, dtype or self.dtype)

    def emit(self, **rec) -> None:
        self.results.append(rec)
        self._emit(rec)

    def time(self, step, x0, iters: int, chained: bool = True) -> float:
        """Seconds per application of `step`: each output feeds the next call
        (or, unchained, every call takes `x0`)."""
        def loop(y, n):
            for _ in range(n):
                out = step(y)
                y = out if chained else x0
            return y

        y = loop(x0, self.warmup)
        if not self.on_card:
            t0 = time.perf_counter()
            loop(y, iters)
            return (time.perf_counter() - t0) / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        loop(y, iters)
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / 1e3 / iters

    def bench(self, name: str, step, x0, ops: float, peak: str = "bf16",
              iters: Optional[int] = None, chained: bool = True, **extra) -> float:
        with torch.inference_mode():
            t = self.time(step, x0, iters or self.iters, chained)
        rec = {"name": name, "ms" if self.on_card else "cpu_ms": t * 1e3, "gflops": ops / 1e9}
        if self.on_card:
            rec[SHARE_KEYS[peak]] = ops / t / PEAKS[peak]
        else:
            rec["device"] = "cpu"
        self.emit(**rec, **extra)
        return t


# ---------------------------------------------------------------------------
# operations of a model forward: aten products and convolutions from
# torch's counter, the hand kernels from the shapes of their launches
# ---------------------------------------------------------------------------

_KERNEL_OPS = {
    "ls_geglu_ffn": lambda a: 24 * a[1] * a[2] ** 2,
    "ls_attn_block": lambda a: a[1] * a[2] * (8 * a[3] * a[4] + 4 * a[2] * a[4]),
    "ls_temporal_attention": lambda a: 4 * a[8] * 16 * 16 * a[9] * a[10],
    "ls_spatial_attention": lambda a: 4 * a[8] * a[9] ** 2 * a[10] * a[11],
    "ls_flash_attention": lambda a: 4 * a[13] * a[15] * a[14] ** 2 * a[16],
    "ls_cross_attn_block": lambda a: a[2] * (4 * a[3] * a[4] * a[7] + 4 * a[5] * a[6] * a[7]
                                             + 4 * a[3] * a[5] * a[7]),
    "ls_quantized_matmul": lambda a: 2 * a[4] * a[5] * a[6],
    "ls_qkv_proj": lambda a: 6 * a[7] * a[8] * a[9],
    "ls_geglu_ffn_int8io": lambda a: 24 * a[2] * a[3] ** 2,
    "ls_oneshot_attention": lambda a: 4 * a[4] * a[5] ** 2 * a[6],
    "ls_flash_kernel": lambda a: 4 * a[4] * a[5] * a[6] * a[7],
}


def count_ops(fn) -> float:
    """Matrix-product and convolution operations of one call of `fn`."""
    from torch.utils.flop_counter import FlopCounterMode

    total = [0]

    def observe(name, args):
        total[0] += _KERNEL_OPS.get(name, lambda a: 0)(args)

    old, _build.observer = _build.observer, observe
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as counter:
            fn()
    finally:
        _build.observer = old
    return float(counter.get_total_flops() + total[0])


def sdpa(q, k, v):
    """The library call on (B, S, H, D) tensors."""
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2)


def fit(out: torch.Tensor, cin: int) -> torch.Tensor:
    """Chained steps must return the input's shape: cut or tile the columns."""
    cout = out.shape[-1]
    if cout >= cin:
        return out[:, :cin].contiguous()
    return out.repeat(1, cin // cout + 1)[:, :cin].contiguous()


# ---------------------------------------------------------------------------
# the modes; each takes its shape table, the full-width one by default
# ---------------------------------------------------------------------------


def attention_shapes(p: Probe):
    """(B, S, heads, D) of the UNet's spatial self-attention at 32² and 16²,
    and of its temporal attention at 32²."""
    return {"spatial": [(p.bf, 1024, 8, 40), (p.bf, 256, 8, 80)],
            "temporal": [(2 * p.w * 1024, 16, 8, 40)]}


def probe_attn(p: Probe, shapes=None):
    """The flash route of ``dot_product_attention`` against the library call."""
    shapes = shapes or attention_shapes(p)
    for b, s, h, d in shapes["spatial"]:
        q = p.randn(b, s, h, d)
        ops = 4 * b * h * s * s * d  # QK^T + PV
        p.bench(f"self_attn_S{s}_C{h * d} (dot_product_attention)",
                lambda y: attention.dot_product_attention(y, y, y), q, ops)
        p.bench(f"self_attn_S{s}_C{h * d} (library sdpa)", lambda y: sdpa(y, y, y), q, ops)
    for b, s, h, d in shapes["temporal"]:
        q = p.randn(b, s, h, d)
        p.bench(f"temporal_attn_S{s}_C{h * d}",
                lambda y: attention.dot_product_attention(y, y, y), q, 4 * b * h * s * s * d)


def probe_spat(p: Probe, shapes=None):
    """The spatial self-attention lowerings at the UNet's shapes: K4, K11
    through its transposes, the flash route, and the library call; then the
    temporal core K3."""
    shapes = shapes or attention_shapes(p)
    for b, s, h, d in shapes["spatial"]:
        c = h * d
        q = p.randn(b, s, c)
        ops = 4 * b * h * s * s * d
        p.bench(f"spat_lane_sliced_S{s}_C{c}", lambda y: ta.spatial_attention(y, y, y, h), q, ops)

        def via_oneshot(y):
            yt = y.reshape(b, s, h, d).transpose(1, 2).reshape(b * h, s, d)
            o = attention.oneshot_attention(yt, yt, yt)
            return o.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, c)

        p.bench(f"spat_oneshot_transposed_S{s}_C{c}", via_oneshot, q, ops)

        def via_flash(y):
            yh = y.reshape(b, s, h, d)
            return attention.dot_product_attention(yh, yh, yh).reshape(b, s, c)

        p.bench(f"spat_flash_S{s}_C{c}", via_flash, q, ops)

        def via_sdpa(y):
            yh = y.reshape(b, s, h, d)
            return sdpa(yh, yh, yh).reshape(b, s, c)

        p.bench(f"spat_library_sdpa_S{s}_C{c}", via_sdpa, q, ops)
    for b, f, h, d in shapes["temporal"]:
        q = p.randn(b, f, h * d)
        ops = 4 * b * h * f * f * d
        p.bench(f"temporal_fused_F{f}_C{h * d}", lambda y: ta.temporal_attention(y, y, y, h), q,
                ops)

        def t_sdpa(y):
            yh = y.reshape(b, f, h, d)
            return sdpa(yh, yh, yh).reshape(b, f, h * d)

        p.bench(f"temporal_library_sdpa_F{f}_C{h * d}", t_sdpa, q, ops)


def level_shapes(p: Probe, levels=((32, 320), (16, 640), (8, 1280))):
    """(frames, H = W, C) of the UNet's resnet convolutions per level."""
    return [(p.bf, hw, c) for hw, c in levels]


def probe_conv(p: Probe, shapes=None):
    for n, hw, c in shapes or level_shapes(p):
        x = p.randn(n, c, hw, hw)
        k3 = p.randn(c, c, 3, 3, s=0.002)
        p.bench(f"conv3x3_{hw}x{hw}x{c}", lambda y: F.conv2d(y, k3, padding=1), x,
                2 * n * hw * hw * 9 * c * c)


def _library_gn(y, scale, bias, eps, silu):
    out = F.group_norm(y, 32, scale.to(y.dtype), bias.to(y.dtype), eps)
    return F.silu(out) if silu else out


def probe_gn(p: Probe, shapes=None):
    """The library GroupNorm + SiLU at the resnets' cross-frame shape."""
    for n, hw, c in shapes or [(2 * p.w, hw, c) for hw, c in ((32, 320), (16, 640))]:
        x = p.randn(n, c, 16, hw, hw)
        sc, bi = torch.ones(c, device=p.device), torch.zeros(c, device=p.device)
        p.bench(f"gn_silu_library_{hw}_{c}", lambda y: _library_gn(y, sc, bi, 1e-5, True), x,
                10 * x.numel())  # an elementwise estimate


def probe_gn2(p: Probe, shapes=None):
    """Cross-frame GroupNorm + SiLU (rows = F·H·W a sample): the library
    call against the streaming kernel K7."""
    for n, hw, c in shapes or [(2 * p.w, hw, c) for hw, c in ((32, 320), (16, 640), (8, 1280))]:
        x = p.randn(n, c, 16, hw, hw)
        sc, bi = torch.ones(c, device=p.device), torch.zeros(c, device=p.device)
        ops = 10 * x.numel()
        p.bench(f"gn_library_crossframe_{hw}_{c}",
                lambda y: _library_gn(y, sc, bi, 1e-5, True), x, ops)
        p.bench(f"gn_kernel_stream_{hw}_{c}",
                lambda y: gn.group_norm_silu_streaming(y, sc, bi, 32, eps=1e-5, silu=True), x, ops)


def probe_gn3(p: Probe, shapes=None):
    """Per-frame GroupNorm (the transformer norms): the library call against
    the single-launch kernel K6."""
    for n, hw, c in shapes or level_shapes(p):
        x = p.randn(n, c, hw, hw)
        sc, bi = torch.ones(c, device=p.device), torch.zeros(c, device=p.device)
        ops = 10 * x.numel()
        p.bench(f"gnpf_library_{hw}_{c}", lambda y: _library_gn(y, sc, bi, 1e-6, False), x, ops)
        p.bench(f"gnpf_kernel_{hw}_{c}",
                lambda y: gn.group_norm_silu(y, sc, bi, 32, eps=1e-6, silu=False), x, ops)


def matmul_shapes(p: Probe):
    """(rows, cin, cout): FF in and out and a q/k/v projection at 32², FF in at 16²."""
    bf = p.bf
    return [(bf * 1024, 320, 2560), (bf * 1024, 1280, 320), (bf * 256, 640, 5120),
            (bf * 1024, 320, 320)]


def _quantize_rows(x: torch.Tensor):
    xf = x.float()
    s = 127.0 / xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.round(xf * s).clamp(-127, 127).to(torch.int8), s


def probe_int8(p: Probe, shapes=None, conv_shapes=None):
    """Is the int8 tensor-core rate real through the library's s8 product
    (``torch._int_mm``), and does it survive dynamic quantization? Products,
    then 3×3 convolutions through the port's int8 convolution route."""
    dt = p.dtype
    for rows, cin, cout in shapes or matmul_shapes(p):
        x = p.randn(rows, cin)
        w = p.randn(cout, cin, s=0.02)
        wq, wsc = _quantize_rows(w)
        wdq = (1.0 / wsc).reshape(1, cout)  # dequantization multipliers
        ops = 2 * rows * cin * cout
        p.bench(f"mm_bf16_{rows}x{cin}x{cout}", lambda y: fit(F.linear(y, w), cin), x, ops)
        # pre-quantized activations: the s8 product alone
        p.bench(f"mm_int8_static_{rows}x{cin}x{cout}",
                lambda y: fit((qconv.int_mm(y.to(torch.int8), wq).float() * wdq).to(dt), cin),
                x, ops, peak="int8")

        def mm_int8_dyn(y):
            yq, ysc = _quantize_rows(y)
            return fit((qconv.int_mm(yq, wq).float() * (wdq / ysc)).to(dt), cin)

        p.bench(f"mm_int8_dyn_{rows}x{cin}x{cout}", mm_int8_dyn, x, ops, peak="int8")
    for n, hw, c in conv_shapes or level_shapes(p):
        x = p.randn(n, c, hw, hw)
        k3 = p.randn(c, c, 3, 3, s=0.02)
        kq = torch.round(k3.float() * 50).clamp(-127, 127).to(torch.int8)
        ops = 2 * n * hw * hw * 9 * c * c
        p.bench(f"conv3x3_bf16_{hw}_{c}", lambda y: F.conv2d(y, k3, padding=1), x, ops)
        p.bench(f"conv3x3_int8_{hw}_{c}",
                lambda y: (qconv.conv_acc(y.to(torch.int8), kq, (1, 1), (1, 1)).float()
                           * 2e-4).to(dt), x, ops, peak="int8")
        p.bench(f"conv3x3_int8_dyn_{hw}_{c}",
                lambda y: qconv.quantized_conv2d(y, k3, None, (1, 1), (1, 1)), x, ops,
                peak="int8")


def ffn_shapes(p: Probe, levels=((1024, 320), (256, 640), (64, 1280))):
    """(M, C) of the transformer feed-forwards per level."""
    return [(p.bf * s_hw, c) for s_hw, c in levels]


def _ffn_weights(p: Probe, c: int):
    inner = 4 * c
    return (p.randn(2 * inner, c, s=0.02), torch.zeros(2 * inner, device=p.device),
            p.randn(c, inner, s=0.02), torch.zeros(c, device=p.device))


def probe_ffn(p: Probe, shapes=None):
    """K1 against the composed feed-forward (two library products around the
    activation), and K9 against one ``F.linear`` on the concatenated weight."""
    dt = p.dtype
    for m, c in shapes or ffn_shapes(p):
        inner = 4 * c
        x = p.randn(m, c)
        w_up, b_up, w_dn, b_dn = _ffn_weights(p, c)
        ops = 2 * m * c * 2 * inner + 2 * m * inner * c  # up pair + down

        def ff_composed(y):
            value, gate = F.linear(y, w_up, b_up.to(dt)).chunk(2, dim=-1)
            return F.linear(value * F.gelu(gate), w_dn, b_dn.to(dt))

        p.bench(f"geglu_composed_M{m}_C{c}", ff_composed, x, ops)
        p.bench(f"geglu_fused_M{m}_C{c}", lambda y: ffn.geglu_ffn(y, w_up, b_up, w_dn, b_dn), x,
                ops)

        wq, wk, wv = (p.randn(c, c, s=0.02) for _ in range(3))
        w3 = torch.cat([wq, wk, wv])
        ops3 = 3 * 2 * m * c * c

        def qkv_library(y):
            q, k, v = F.linear(y, w3).chunk(3, dim=-1)
            return q + k + v

        def qkv_fused(y):
            q, k, v = ffn.qkv_proj(y, wq, wk, wv)
            return q + k + v

        p.bench(f"qkv_library_linear_M{m}_C{c}", qkv_library, x, ops3)
        p.bench(f"qkv_fused_M{m}_C{c}", qkv_fused, x, ops3)


def probe_ffn8(p: Probe, shapes=None):
    """K1 with bf16 activations against K10, whose int8 activations and row
    scales feed the next iteration as they would flow between ops."""
    for m, c in shapes or ffn_shapes(p, ((1024, 320), (256, 640))):
        inner = 4 * c
        x = p.randn(m, c)
        w_up, b_up, w_dn, b_dn = _ffn_weights(p, c)
        ops = 2 * m * c * 2 * inner + 2 * m * inner * c
        p.bench(f"geglu_bf16io_M{m}_C{c}", lambda y: ffn.geglu_ffn(y, w_up, b_up, w_dn, b_dn), x,
                ops)
        p.bench(f"geglu_int8io_M{m}_C{c}",
                lambda carry: ffn.geglu_ffn_int8io(*carry, w_up, b_up, w_dn, b_dn),
                ffn.quantize_rowwise(x), ops)


def probe_qmm(p: Probe, shapes=None):
    """K8 (activation quantization and dequantization inside the launch)
    against the bf16 library product."""
    for rows, cin, cout in shapes or matmul_shapes(p):
        x = p.randn(rows, cin)
        w = p.randn(cout, cin, s=0.02, dtype=torch.float32)
        wb = w.to(p.dtype)
        ops = 2 * rows * cin * cout
        p.bench(f"qmm_bf16_{rows}x{cin}x{cout}", lambda y: fit(F.linear(y, wb), cin), x, ops)
        p.bench(f"qmm_kernel_{rows}x{cin}x{cout}",
                lambda y: fit(qmm.quantized_matmul(y, w), cin), x, ops, peak="int8")


def _latent_hw(cfg: LatentSyncConfig) -> int:
    return cfg.data.resolution // cfg.vae.scale_factor


def probe_unet(p: Probe, cfg: Optional[LatentSyncConfig] = None, ablate: bool = False,
               iters: int = 5):
    """The UNet forward at batch 2·w, random seeded weights; with `ablate`,
    also without the motion modules, without the audio layers, and with
    resnets only, to attribute the forward to its op families."""
    from ..models.unet3d import UNet3DConditionModel
    from ..utils.convert import init_random_

    cfg = cfg or LatentSyncConfig()
    variants = [("full", cfg.unet)]
    if ablate:
        n = len(cfg.unet.down_block_types)
        variants += [
            ("no_temporal", dataclasses.replace(cfg.unet, use_motion_module=False)),
            ("no_audio", dataclasses.replace(cfg.unet, add_audio_layer=False)),
            ("resnets_only", dataclasses.replace(
                cfg.unet, use_motion_module=False, add_audio_layer=False,
                down_block_types=("DownBlock3D",) * n, up_block_types=("UpBlock3D",) * n)),
        ]
    b, f, lat = 2 * p.w, cfg.data.num_frames, _latent_hw(cfg)
    for name, ucfg in variants:
        unet = init_random_(UNet3DConditionModel(ucfg), seed=0).to(p.device, p.dtype).eval()
        audio = p.randn(b, f, 50, ucfg.cross_attention_dim)
        tvec = torch.full((b,), 500, device=p.device)
        sample = p.randn(b, ucfg.in_channels, f, lat, lat)
        nc = ucfg.out_channels

        def step(y):
            return torch.cat([unet(y, tvec, audio), y[:, nc:]], dim=1)

        ops = count_ops(lambda: unet(sample, tvec, audio))
        t = p.bench(f"unet_fwd_{name}_b{b}", step, sample, ops, iters=iters)
        if name == "full":
            p.emit(name="denoise_estimate", fps_at_20steps=p.w * f / (t * 20),
                   device=p.device.type)
        del unet


def probe_tmod(p: Probe, cfg: Optional[LatentSyncConfig] = None, levels=None, iters: int = 5):
    """One TemporalModule per UNet level, and the time of the level's
    family: at the release config 5 modules at 32², 16² and 8², 6 at 4²."""
    from ..models.unet3d import TemporalModule
    from ..utils.convert import init_random_

    cfg = cfg or LatentSyncConfig()
    b, f = 2 * p.w, cfg.data.num_frames
    for res, c, n_mod in levels or ((32, 320, 5), (16, 640, 5), (8, 1280, 5), (4, 1280, 6)):
        mod = init_random_(TemporalModule(c, cfg.unet.motion_module, cfg.unet.norm_num_groups),
                           seed=0).to(p.device, p.dtype).eval()
        x0 = p.randn(b, c, f, res, res)
        ops = count_ops(lambda: mod(x0))
        t = p.bench(f"tmod_res{res}_c{c}", mod, x0, ops, iters=iters)
        p.emit(name=f"tmod_res{res}_c{c}_family", n_modules=n_mod,
               **{"family_ms" if p.on_card else "family_cpu_ms": t * 1e3 * n_mod})
        del mod


def _models(p: Probe, cfg: LatentSyncConfig):
    from ..audio.features import Audio2Feature
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    from ..models.whisper import WhisperEncoder
    from ..utils.convert import init_random_

    return (init_random_(UNet3DConditionModel(cfg.unet), seed=0),
            init_random_(AutoencoderKL(cfg.vae), seed=1),
            Audio2Feature(init_random_(WhisperEncoder(cfg.whisper), seed=2)))


def probe_denoise(p: Probe, cfg: Optional[LatentSyncConfig] = None, steps: int = 20,
                  rounds: int = 3):
    """The whole denoise loop (DDIM steps at CFG 1.5) on w // 2 windows:
    what it costs beyond `steps` forwards is loop overhead."""
    from ..pipelines.lipsync import LipsyncPipeline

    cfg = cfg or LatentSyncConfig()
    unet, vae, audio_encoder = _models(p, cfg)
    pipe = LipsyncPipeline(unet, vae, audio_encoder, cfg, dtype=p.dtype, device=p.device)
    f, lat = cfg.data.num_frames, _latent_hw(cfg)
    ww = max(1, p.w // 2)
    f32 = torch.float32
    lat0 = p.randn(1, 1, lat, lat, 4, dtype=f32).expand(ww, f, lat, lat, 4)
    mask = torch.ones((ww, f, lat, lat, 1), device=p.device)
    masked, ref = (p.randn(ww, f, lat, lat, 4, dtype=f32) for _ in range(2))
    audio = p.randn(ww, f, 50, cfg.unet.cross_attention_dim, dtype=f32)
    t = p.time(lambda _: pipe._denoise(lat0, mask, masked, ref, audio, steps, 1.5), None, rounds,
               chained=False)
    p.emit(name=f"denoise{steps}_W{ww}", **{"ms" if p.on_card else "cpu_ms": t * 1e3},
           device=p.device.type)


def probe_vae(p: Probe, cfg: Optional[LatentSyncConfig] = None, batches=(32, 64),
              rounds: int = 5):
    """VAE encode and decode at the serving chunk shapes."""
    from ..models.vae import AutoencoderKL
    from ..utils.convert import init_random_

    cfg = cfg or LatentSyncConfig()
    vae = init_random_(AutoencoderKL(cfg.vae), seed=1).to(p.device, p.dtype).eval()
    res, lat = cfg.data.resolution, _latent_hw(cfg)
    for n in batches:
        pix = p.randn(n, 3, res, res, s=0.3)
        z = p.randn(n, cfg.vae.latent_channels, lat, lat)
        for name, fn, x in (("vae_encode", vae.encode, pix), ("vae_decode", vae.decode, z)):
            ops = count_ops(lambda: fn(x))
            p.bench(f"{name}_n{n}", fn, x, ops, iters=rounds, chained=False)


MODES = {
    "attn": probe_attn, "spat": probe_spat, "conv": probe_conv, "gn": probe_gn,
    "gn2": probe_gn2, "gn3": probe_gn3, "int8": probe_int8, "ffn": probe_ffn,
    "ffn8": probe_ffn8, "qmm": probe_qmm, "unet": probe_unet,
    "ablate": lambda p, *a, **kw: probe_unet(p, *a, ablate=True, **kw), "tmod": probe_tmod,
    "denoise": probe_denoise, "vae": probe_vae,
}


def run(p: Probe, which: str, *args, **kwargs) -> None:
    """Run mode `which` ("all": every ported mode but ablate, which repeats
    unet) on probe `p`."""
    if which in UNPORTED:
        raise NotImplementedError(f"micro_probe --which {which} is not ported: {UNPORTED[which]}")
    if which == "all":
        for name, fn in MODES.items():
            if name != "ablate":
                fn(p)
        return
    if which not in MODES:
        raise ValueError(f"unknown mode {which!r}; modes: all, {', '.join(MODES)}, and the "
                         f"unported {', '.join(UNPORTED)}")
    MODES[which](p, *args, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="attn")
    ap.add_argument("--w", type=int, default=4, help="windows")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("micro_probe: no CUDA device (torch.cuda.is_available() is false); pass "
                  "--device cpu to run the plain versions on the CPU", file=sys.stderr)
            return 2
        print(gpu_line(), flush=True)
    run(Probe(device, args.w, args.iters), args.which)
    return 0


if __name__ == "__main__":
    sys.exit(main())
