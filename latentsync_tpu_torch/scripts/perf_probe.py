"""Component-level FLOP audit of the generation path on the card (the port's
counterpart of ``scripts/perf_probe.py``).

    python -m latentsync_tpu_torch.scripts.perf_probe [--windows 4] [--rounds 5]

Times the UNet forward at the CFG batch (2·W windows), the VAE encode and
decode of a window batch's faces (W·16 at 256²) and the whole denoise of W
windows (20 DDIM steps, CFG 1.5, the FLOP-cut switches as set), best of
``--rounds`` after a warm call, on seeded random weights in bf16 (the
full-width default configuration unless ``--config`` names a stage YAML).
It counts each one's FLOPs and prints its share of the H100's 989 TFLOP/s
bf16 peak, one JSON line a component after a line with the card's name and
power limit.

The count: ``torch.utils.flop_counter.FlopCounterMode`` sees aten ops only,
not a hand kernel's ctypes launch, so each call is counted on the ``meta``
device (no memory, no time) with every wrapper's plain version
(``ops/plain.py``): the same products the kernels compute, multiply-adds
counted twice, elementwise work not at all. The UNet's count is held
against ``op_tally.py``'s analytic product families at the same shape and
printed beside it (``flops_check``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

import torch

from .micro_probe import gpu_line
from .op_tally import PEAK_BF16


def count_flops(fn, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` on meta tensors, the kernels' plain
    versions standing in for their launches."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.plain import plain_kernels

    with plain_kernels(), FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args, **kwargs)
    return counter.get_total_flops()


def meta_model(build, dtype=torch.bfloat16):
    """``build()`` on the meta device, buffers made from host arrays too."""
    with torch.device("meta"):
        model = build()
    return model.to("meta", dtype).eval()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def unet_flops(unet_cfg, batch: int, frames: int, latent: int, audio_tokens: int = 50,
               dtype=torch.bfloat16) -> int:
    from ..models.unet3d import UNet3DConditionModel

    unet = meta_model(lambda: UNet3DConditionModel(unet_cfg), dtype)
    return count_flops(unet, _meta(batch, unet_cfg.in_channels, frames, latent, latent,
                                   dtype=dtype),
                       _meta(batch, dtype=torch.long),
                       _meta(batch, frames, audio_tokens, unet_cfg.cross_attention_dim,
                             dtype=dtype))


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(t) for t in tree)
    return tree


def denoise_flops(pipe, windows: int, steps: int, guidance: float, audio_tokens: int = 50) -> int:
    """FLOPs of ``pipe._denoise`` on `windows` windows: the pipeline's own
    schedule (CFG batch, interval and DeepCache reads as switched) run on
    the meta device, each distinct UNet call (batch, cache arguments)
    counted once on a meta copy of its UNet and added at every step that
    makes it."""
    from ..models.unet3d import UNet3DConditionModel
    from ..pipelines.lipsync import LipsyncPipeline

    cfg = pipe.config
    f, lat = cfg.data.num_frames, cfg.data.resolution // cfg.vae.scale_factor
    meta_unet = meta_model(lambda: UNet3DConditionModel(cfg.unet), pipe.dtype)
    seen, total = {}, [0]

    def unet(x, t, audio, **kw):
        key = (tuple(x.shape), tuple(audio.shape), _shapes(kw.pop("deep_cache", None)),
               tuple(sorted(kw.items())))
        if key not in seen:
            out = []
            flops = count_flops(lambda: out.append(meta_unet(x, t, audio, deep_cache=None
                                                             if key[2] is None else
                                                             _meta_like(key[2], pipe.dtype),
                                                             **kw)))
            seen[key] = (flops, out[0])
        total[0] += seen[key][0]
        return seen[key][1]

    stand_in = types.SimpleNamespace(
        _flop_cut_knobs=pipe._flop_cut_knobs, dtype=pipe.dtype, scheduler=pipe.scheduler,
        device=torch.device("meta"), unet=unet)
    lat4 = _meta(windows, f, lat, lat, 4, dtype=torch.float32)
    LipsyncPipeline._denoise(stand_in, lat4, _meta(windows, f, lat, lat, 1, dtype=torch.float32),
                             lat4, lat4, _meta(windows, f, audio_tokens,
                                               cfg.unet.cross_attention_dim,
                                               dtype=torch.float32), steps, guidance)
    return total[0]


def _meta_like(shapes, dtype):
    if shapes and isinstance(shapes[0], int):
        return _meta(*shapes, dtype=dtype)
    return tuple(_meta_like(s, dtype) for s in shapes)


def vae_flops(vae_cfg, frames: int, res: int, dtype=torch.bfloat16):
    """(encode, decode) FLOPs of `frames` faces at `res`²."""
    from ..models.vae import AutoencoderKL

    vae = meta_model(lambda: AutoencoderKL(vae_cfg), dtype)
    lat = res // vae_cfg.scale_factor
    return (count_flops(vae.encode, _meta(frames, 3, res, res, dtype=dtype)),
            count_flops(vae.decode, _meta(frames, vae_cfg.latent_channels, lat, lat,
                                          dtype=dtype)))


def best_ms(fn, device, rounds: int) -> float:
    fn()
    times = []
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def probe(windows: int = 4, rounds: int = 5, config: str = "", device="cuda", seed: int = 0,
          emit=print, pipe=None):
    """Run the probe; `emit` gets each JSON line. Returns the report. With
    `pipe` (a ``LipsyncPipeline``) its models, config, dtype and device
    are probed instead of new seeded ones."""
    import numpy as np

    from ..config import LatentSyncConfig, load_unet_config
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    from ..pipelines.lipsync import LipsyncPipeline
    from ..utils.convert import init_random_
    from .op_tally import PRODUCT_FAMILIES, tally

    if pipe is None:
        dev = torch.device(device)
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        cfg = load_unet_config(config) if config else LatentSyncConfig()
        unet = init_random_(UNet3DConditionModel(cfg.unet), seed=seed)
        vae = init_random_(AutoencoderKL(cfg.vae), seed=seed + 1)
        pipe = LipsyncPipeline(unet, vae, None, cfg, dtype=dtype, device=dev)
    dev, dtype, cfg = pipe.device, pipe.dtype, pipe.config
    f, res = cfg.data.num_frames, cfg.data.resolution
    lat = res // cfg.vae.scale_factor
    steps, guidance = cfg.run.inference_steps, cfg.run.guidance_scale
    d = cfg.unet.cross_attention_dim
    rng = np.random.default_rng(seed)

    def normal(*shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)

    report = {}

    def put(name, ms, flops, **extra):
        row = {"component": name, "ms": ms, "tflop": flops / 1e12,
               "tflops_per_s": flops / (ms / 1e3) / 1e12,
               "share_of_bf16_peak": flops / (ms / 1e3) / PEAK_BF16, **extra}
        report[name] = row
        emit(json.dumps(row))

    b = 2 * windows
    sample, audio = normal(b, cfg.unet.in_channels, f, lat, lat), normal(b, f, 50, d)
    t = torch.full((b,), 500, device=dev, dtype=torch.long)
    fl = unet_flops(cfg.unet, b, f, lat, 50, dtype)
    analytic = tally(windows, cfg.unet, frames=f, latent=lat)
    products = sum(analytic.get(k, 0.0) for k in PRODUCT_FAMILIES)
    check = {"component": "flops_check", "flop_counter_tflop": fl / 1e12,
             "op_tally_product_tflop": products / 1e12, "ratio": fl / products}
    report["flops_check"] = check
    emit(json.dumps(check))
    with torch.inference_mode():
        put("unet_fwd", best_ms(lambda: pipe.unet(sample, t, audio), dev, rounds), fl,
            batch=b)
        n = windows * f
        pix = normal(n, 3, res, res) * 0.3
        z = normal(n, cfg.vae.latent_channels, lat, lat)
        enc, dec = vae_flops(cfg.vae, n, res, dtype)
        put("vae_encode", best_ms(lambda: pipe.vae.encode(pix), dev, rounds), enc, frames=n)
        put("vae_decode", best_ms(lambda: pipe.vae.decode(z), dev, rounds), dec, frames=n)
    lat4 = normal(windows, f, lat, lat, 4, dt=torch.float32)
    args = (lat4, torch.ones(windows, f, lat, lat, 1, device=dev), lat4, lat4,
            normal(windows, f, 50, d, dt=torch.float32), steps, guidance)
    dn = denoise_flops(pipe, windows, steps, guidance)
    ms = best_ms(lambda: pipe._denoise(*args), dev, max(1, rounds // 2))
    put("denoise", ms, dn, steps=steps, windows=windows, frames_per_s=n / (ms / 1e3))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--config", default="", help="a stage YAML (the default config if empty)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("perf_probe", args.device):
        return 2
    if torch.device(args.device).type == "cuda":
        print(gpu_line(), flush=True)
    probe(args.windows, args.rounds, args.config, args.device, args.seed,
          emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
