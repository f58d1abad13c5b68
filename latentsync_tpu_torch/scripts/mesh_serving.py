"""Serve one window batch across the cards of a launch: the UNet forward and
the 20-step denoise under every dp × tp mesh the world allows, each against
the single-rank run on the same inputs.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m latentsync_tpu_torch.scripts.mesh_serving [--windows 4] [--profile]
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m latentsync_tpu_torch.scripts.mesh_serving --device cpu --config tiny.yaml

The counterpart of the JAX package's multi-chip serving
(``tests/test_mesh_serving.py``: windows on the ``data`` axis, each CFG pair
with its window, and ``param_tp_sharding`` on the ``model`` axis), over
``parallel/mesh.py``. By default the model is the full-width stage-2 UNet
(``configs/unet_stage2.yaml``, or ``--config`` for another stage YAML) with
seeded random weights (drawn on the rank's device), bf16, the config's 20
DDIM steps at CFG 1.5 (``--steps`` for fewer), on the card (NCCL;
``--device cpu``: gloo, f32). ``--payload`` instead reads a ``torch.save``
of ``{"config", "unet", "inputs", "steps", "guidance"}`` (a state dict and
the ``_denoise`` / forward inputs), and ``--out`` writes rank 0's results
there. The served configuration is the environment's switches
(``LATENTSYNC_FUSED_XATTN``, ``LATENTSYNC_INT8``, ...), as on one card. Every rank first runs the single-rank forward and denoise with the
whole model, then for each layout (``--layouts 2x2,4x1``; by default every
dp × tp = world whose dp divides the windows) keeps only its shards,
serves the same windows and checks the result, gathered back to every rank,
against the single-rank one. Rank 0 prints a JSON line of the single-rank
run (its window batch's wall ms, with ``--profile`` its device ms, and its
peak device memory), then one a layout: the
distance (max abs, relative L2), the window batch's wall ms, the kernels'
launches of one forward (K1-K8 and the int8 convolution route) beside the single-rank forward's at the same
per-rank shape, the all-gathers a forward, peak device memory per rank, and
with ``--profile`` the device time of one window batch and the
all-gathers' share of it (``torch.profiler``). Exit 1 if a layout's
distance exceeds ``--tol`` or its launches differ.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

def _counters():
    """The counted wrappers of the UNet's kernels in every served
    configuration, by name: K1-K4 (default), K5-K7 (fused), K8 and the int8
    convolution route (int8, int8-dense)."""
    from ..ops import attn_block, ffn, qconv, qmm
    from ..ops import groupnorm as gn
    from ..ops import temporal_attention as ta

    return {"geglu_ffn": ffn.geglu_ffn, "self_attention_block": attn_block.self_attention_block,
            "temporal_attention": ta.temporal_attention,
            "spatial_attention": ta.spatial_attention,
            "cross_attention_block": attn_block.cross_attention_block,
            "group_norm_silu": gn.group_norm_silu,
            "group_norm_silu_streaming": gn.group_norm_silu_streaming,
            "quantized_matmul": qmm.quantized_matmul, "conv_acc": qconv.conv_acc}


def _inputs(cfg, windows: int, seed: int):
    """Seeded window batch at the config's shapes: `_denoise`'s inputs
    (channels-last) and a forward's (sample, t, audio) at the CFG batch."""
    rng = np.random.default_rng(seed)
    f, lat = cfg.data.num_frames, cfg.data.resolution // cfg.vae.scale_factor
    d = cfg.unet.cross_attention_dim

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {"latents0": normal(windows, f, lat, lat, 4),
            "mask": torch.ones(windows, f, lat, lat, 1),
            "masked": normal(windows, f, lat, lat, 4), "ref": normal(windows, f, lat, lat, 4),
            "audio": normal(windows, f, 50, d),
            "sample": normal(2 * windows, cfg.unet.in_channels, f, lat, lat),
            "t": torch.full((2 * windows,), 317, dtype=torch.int64),
            "audio2": normal(2 * windows, f, 50, d)}


def _layouts(world: int, windows: int, spec: str):
    if spec:
        return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]
    return [(world // tp, tp) for tp in range(1, world + 1)
            if world % tp == 0 and windows % (world // tp) == 0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _device_ms(fn):
    """(device ms of all kernels, of the all-gathers') in one call of `fn`
    under ``torch.profiler`` (device activity only: each row a kernel,
    counted once); (None, None) if the trace has no device time. A
    collective's kernel runs until every rank of its group has joined, so
    its time includes the wait for the slowest rank."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = gathers = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", 0.0) or 0.0
        total += t
        if "nccl" in e.key.lower():
            gathers += t
    return (total / 1e3, gathers / 1e3) if total else (None, None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/unet_stage2.yaml")
    p.add_argument("--payload", default="")
    p.add_argument("--out", default="")
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--steps", type=int, default=0, help="DDIM steps (0: the config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layouts", default="", help="dp x tp list, e.g. 2x2,4x1")
    p.add_argument("--tol", type=float, default=0.0,
                   help="largest relative L2 from the single-rank result (0: 1e-5 in f32, "
                        "0.05 in bf16)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    t_start = time.time()

    import torch.distributed as dist

    from ..config import load_unet_config
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    from ..parallel import mesh as pm
    from ..pipelines.lipsync import LipsyncPipeline
    from ..utils.convert import init_random_
    from .inference import no_card

    if no_card("mesh_serving", args.device):
        return 2
    device = pm.card_of_rank(args.device)
    if "WORLD_SIZE" not in os.environ:
        print("mesh_serving: launch under python -m torch.distributed.run", file=sys.stderr)
        return 2
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()

    if args.payload:
        payload = torch.load(args.payload, weights_only=False)
        cfg, steps, guidance = payload["config"], payload["steps"], payload["guidance"]
        unet = UNet3DConditionModel(cfg.unet)
        unet.load_state_dict(payload["unet"])
        inputs = payload["inputs"]
    else:
        cfg = load_unet_config(args.config)
        steps, guidance = args.steps or cfg.run.inference_steps, cfg.run.guidance_scale
        # drawn on the rank's own device (the same values on every rank)
        with torch.device(device):
            unet = UNet3DConditionModel(cfg.unet).to(device)
        init_random_(unet, seed=args.seed, device=device)
        inputs = _inputs(cfg, args.windows, args.seed + 1)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    tol = args.tol or (0.05 if dtype == torch.bfloat16 else 1e-5)
    vae = AutoencoderKL(cfg.vae)
    pipe = LipsyncPipeline(copy.deepcopy(unet), vae, None, cfg, dtype=dtype, device=device)
    unet = unet.cpu()  # the whole model stays on the host between layouts
    x = {k: v.to(device) for k, v in inputs.items()}
    windows = x["latents0"].shape[0]
    counters = _counters()

    def forward(model, sample, t, audio):
        with torch.inference_mode():
            return model(sample.to(dtype), t, audio.to(dtype)).float()

    def denoise(*batch):
        with torch.inference_mode():
            return pipe._denoise(*batch, steps, guidance)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        return out, {k: c.launches for k, c in counters.items()}

    batch = (x["latents0"], x["mask"], x["masked"], x["ref"], x["audio"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    single_fwd = forward(pipe.unet, x["sample"], x["t"], x["audio2"])
    single = denoise(*batch)
    sync()
    t0 = time.perf_counter()
    denoise(*batch)
    sync()
    single_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = _device_ms(lambda: denoise(*batch))[0] if args.profile and device.type == "cuda" \
        else None
    if rank == 0:
        print(json.dumps({
            "single_rank": True, "windows": windows, "steps": steps,
            "window_batch_wall_ms": single_ms, "device_ms": dev_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
            else None}), flush=True)
    results = {"single": {"forward": single_fwd.cpu(), "denoise": single.cpu()}}
    pipe.unet = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok = True
    for dp, tp in _layouts(world, windows, args.layouts):
        if rank == 0:
            print(f"mesh_serving: layout {dp}x{tp} at {time.time() - t_start:.1f} s",
                  file=sys.stderr, flush=True)
        mesh = pm.make_mesh(dp * tp, model_parallel=tp)
        if not mesh.member:
            continue
        # the single-rank forward at this rank's shape: the default path's launches
        rows = pm.batch_sharding(mesh).piece(x["sample"].shape[0])
        ref_model = copy.deepcopy(unet).to(device, dtype).eval()
        _, want = counted(lambda: forward(ref_model, x["sample"][rows], x["t"][rows],
                                          x["audio2"][rows]))
        del ref_model
        local = copy.deepcopy(unet).to(dtype)
        sharded = pm.tensor_parallel_(local, mesh)
        pipe.unet = local.to(device).eval()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        pm.all_gather.launches = 0
        fwd, launches = counted(lambda: pm.data_parallel_call(
            mesh, lambda *a: forward(pipe.unet, *a), x["sample"], x["t"], x["audio2"]))
        gathers = pm.all_gather.launches
        out = pm.data_parallel_call(mesh, denoise, *batch)
        sync()
        t0 = time.perf_counter()
        again = pm.data_parallel_call(mesh, denoise, *batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = gather_ms = None
        if args.profile and device.type == "cuda":
            dev_ms, gather_ms = _device_ms(lambda: pm.data_parallel_call(mesh, denoise, *batch))
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
        peaks = [None] * world
        dist.all_gather_object(peaks, peak)
        rel_fwd, rel_dn = _rel(fwd, single_fwd), _rel(out, single)
        good = rel_fwd <= tol and rel_dn <= tol and torch.equal(out, again) \
            and (device.type == "cpu" or launches == want) and bool(torch.isfinite(out).all())
        ok &= good
        results[f"{dp}x{tp}"] = {"forward": fwd.cpu(), "denoise": out.cpu()}
        if rank == 0:
            print(json.dumps({
                "layout": f"{dp}x{tp}", "dp": dp, "tp": tp, "windows": windows, "steps": steps,
                "dtype": str(dtype).removeprefix("torch."), "sharded_params": len(sharded),
                "forward_rel_l2": rel_fwd,
                "forward_max_abs": float((fwd - single_fwd).abs().max()),
                "denoise_rel_l2": rel_dn, "denoise_max_abs": float((out - single).abs().max()),
                "repeat_bitwise": bool(torch.equal(out, again)), "tol": tol,
                "window_batch_wall_ms": wall_ms, "device_ms": dev_ms,
                "all_gather_ms": gather_ms,
                "all_gather_share": None if not dev_ms else gather_ms / dev_ms,
                "all_gathers_a_forward": gathers, "launches_a_forward": launches,
                "single_rank_launches": want, "peak_gib_per_rank": peaks, "ok": good}),
                flush=True)
        pipe.unet = None
        del local
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0 and args.out:
        torch.save(results, args.out)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
