"""End-to-end training evidence: the training CLIs' whole loop on seeded
synthetic clips (the port's counterpart of ``scripts/train_artifact.py``).

    python -m latentsync_tpu_torch.scripts.train_artifact [--out train.json] \\
        [--device cpu] [--steps 50]

Writes moving-blob clips with sine-sweep ``.wav`` sidecars and small YAML
configs into ``--workdir`` (a temporary directory by default), then drives
``train_unet`` and ``train_syncnet`` (their ``main``, in this process):

- the UNet: ``--steps`` steps with a checkpoint and a scored validation
  render every ``--steps / 2`` (the SyncNet scorer's confidence), then
  ``--resume`` for ``--resume-steps`` more from the latest checkpoint;
- the UNet on one fixed batch and noise with every parameter trained
  (``--overfit``): its eps-MSE must fall below half its first value and
  below 0.5, the plateau an eps predictor sits at on fresh random data;
- the UNet with the whole stage-2 loss stack (pixel-space decode, LPIPS,
  TREPA, the frozen SyncNet) for ``--fullstack-steps`` steps;
- SyncNet: ``--steps`` steps with validation, then ``--resume``;
- data parallelism: ``train_unet`` under ``python -m torch.distributed.run``
  on ``--dp-ranks`` ranks (gloo on the CPU, NCCL on the cards), started
  first and collected last.

It checks each stage, as the JAX script does: the UNet's and SyncNet's
losses fall (the mean of the last third below the first third's) and the
overfit run's falls below its plateau; a step checkpoint; the resume
announced and continued; a validation video with a confidence, and the
first and last validation videos apart (mean abs > 0.01: validation reads
the updated weights); every loss component finite; SyncNet's gradients
live (its last ``sat_frac`` below 0.5); every data-parallel rank in the
run. Then it prints one JSON summary; the whole report goes to ``--out``
only where given. Exit 1 if a check fails. The card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_UNET = {"block_out_channels": [32, 64, 64, 64], "layers_per_block": 1, "norm_num_groups": 8,
         "cross_attention_dim": 16, "attention_head_dim": 4,
         "motion_module": {"num_attention_heads": 4, "num_transformer_block": 1}}
_VAE = {"block_out_channels": [16, 32, 32, 32], "layers_per_block": 1, "norm_num_groups": 8}
_SYNCNET_TOWERS = {
    "audio_encoder": {"in_channels": 1, "block_out_channels": [4, 4, 8, 8, 16, 16, 128],
                      "downsample_factors": [[2, 1], 2, 2, 1, 2, 2, [2, 3]],
                      "attn_blocks": [0, 0, 0, 1, 1, 0, 0]},
    "visual_encoder": {"in_channels": 48, "block_out_channels": [4, 4, 8, 8, 16, 128],
                       "downsample_factors": [[1, 2], 2, 2, 2, 2, 2],
                       "attn_blocks": [0, 0, 0, 0, 1, 0]}}


def configs(files: str, val_video: str, val_audio: str, save_every: int):
    """The four runs' config trees (the JAX script's YAMLs, on a fileslist)."""
    data = {"num_frames": 4, "resolution": 64, "batch_size": 4, "train_fileslist": files}
    unet = {"model": _UNET, "vae": _VAE,
            "data": dict(data, val_video_path=val_video, val_audio_path=val_audio),
            "run": {"pixel_space_supervise": False, "use_syncnet": False,
                    "save_ckpt_steps": save_every, "inference_steps": 3, "lr": 1e-3,
                    # conv_out starts at zero (the trainer's fast_init), so the
                    # motion and attention modules alone get no gradient from scratch
                    "trainable_modules": ["motion_modules.", "attentions.", "conv_out"]}}
    overfit = {"model": _UNET, "vae": _VAE, "data": data,
               "run": {"pixel_space_supervise": False, "use_syncnet": False,
                       "use_mixed_noise": False, "save_ckpt_steps": 100000,
                       "trainable_modules": [], "lr": 2e-3}}
    fullstack = {"model": dict(_UNET, block_out_channels=[16, 32, 32, 32]),
                 "syncnet": _SYNCNET_TOWERS, "vae": _VAE,
                 "data": dict(data, num_frames=16, batch_size=2),
                 "run": {"pixel_space_supervise": True, "use_syncnet": True,
                         "perceptual_loss_weight": 0.1, "trepa_loss_weight": 1.0,
                         "sync_loss_weight": 0.05, "save_ckpt_steps": 100000, "lr": 1e-3,
                         "trainable_modules": ["motion_modules.", "attentions.", "conv_out"]}}
    syncnet = {"syncnet": dict(_SYNCNET_TOWERS, visual_encoder=dict(
        _SYNCNET_TOWERS["visual_encoder"], block_out_channels=[4, 4, 8, 8, 16, 16, 32, 128],
        downsample_factors=[[1, 2], 2, 2, 2, 2, 2, 2, 2], attn_blocks=[0, 0, 0, 0, 1, 1, 0, 0])),
        "vae": _VAE, "data": dict(data, num_frames=16, resolution=256, val_fileslist=files),
        "run": {"lr": 1e-3, "save_ckpt_steps": 100000}}
    return {"unet": unet, "overfit": overfit, "fullstack": fullstack, "syncnet": syncnet}


def synthesize_clips(out_dir: str, n: int = 3, frames: int = 60, size=(96, 80),
                     fps: int = 25) -> list:
    """Moving-blob clips and sine-sweep ``.wav`` sidecars (the JAX script's)."""
    import cv2
    from scipy.io import wavfile

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    rng = np.random.default_rng(0)
    h, w = size
    for i in range(n):
        path = os.path.join(out_dir, f"clip_{i}.mp4")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        base = rng.integers(40, 200, (h, w, 3)).astype(np.uint8)
        for t in range(frames):
            img = base.copy()
            cx = int(w / 2 + (w / 4) * np.sin(2 * np.pi * t / frames + i))
            cy = int(h / 2 + (h / 4) * np.cos(2 * np.pi * t / frames))
            cv2.circle(img, (cx, cy), 12, (230, 180, 60), -1)
            cv2.ellipse(img, (w // 2, 2 * h // 3), (10, 4 + (t % 5)), 0, 0, 360, (40, 30, 150),
                        -1)
            wr.write(img)
        wr.release()
        dur = frames / fps
        ts = np.linspace(0, dur, int(16000 * dur), endpoint=False)
        tone = 0.3 * np.sin(2 * np.pi * (220 + 40 * i + 100 * ts) * ts)
        wavfile.write(os.path.splitext(path)[0] + ".wav", 16000, (tone * 32767).astype(np.int16))
        paths.append(path)
    return paths


def run_cli(module: str, argv: list):
    """``latentsync_tpu_torch.scripts.<module>.main(argv)`` in this process:
    (its JSON lines, wall seconds); raises on a non-zero exit."""
    import importlib

    main = importlib.import_module(f"latentsync_tpu_torch.scripts.{module}").main
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{module} {argv} exited {rc}:\n{buf.getvalue()[-3000:]}")
    return _records(buf.getvalue()), time.time() - t0


def _records(text: str):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return out


def loss_series(records):
    return [(r["step"], r["loss"]) for r in records if "loss" in r]


def decreasing(series) -> bool:
    """The mean of the last third below the first third's."""
    if len(series) < 3:
        return False
    vals = [v for _, v in series]
    k = max(1, len(vals) // 3)
    return float(np.mean(vals[-k:])) < float(np.mean(vals[:k]))


def video_diff(a: str, b: str) -> float:
    """Mean absolute difference of two videos' frames (the shorter's count)."""
    from ..utils.media import read_video

    va = read_video(a, change_fps=False).astype(np.float32)
    vb = read_video(b, change_fps=False).astype(np.float32)
    n = min(len(va), len(vb))
    return float(np.mean(np.abs(va[:n] - vb[:n])))


def _write(path: str, tree) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return path


def run(workdir: str, device: str = "cuda", steps: int = 50, resume_steps: int = 10,
        overfit_steps: int = 45, fullstack_steps: int = 4, dp_ranks: int = 2,
        log_every: int = 5, trees=None, val_frames: int = 60):
    """Every stage; returns (report, ok). `trees` overrides `configs`'
    trees by name (smaller ones in tests); the validation clip has
    `val_frames` frames (the JAX script validates on a training clip of
    60)."""
    data_dir = os.path.join(workdir, "data")
    clips = synthesize_clips(data_dir)
    val = synthesize_clips(os.path.join(workdir, "val"), n=1, frames=val_frames)[0]
    files = os.path.join(data_dir, "files.txt")
    with open(files, "w") as f:
        f.write("\n".join(clips) + "\n")
    save_every = max(1, steps // 2)
    trees = dict(configs(files, val, os.path.splitext(val)[0] + ".wav", save_every),
                 **(trees or {}))
    paths = {k: _write(os.path.join(workdir, f"{k}.yaml"), v) for k, v in trees.items()}
    common = ["--device", device, "--log-every", str(log_every)]
    report = {"device": device, "steps": steps, "resume_steps": resume_steps}
    checks = {}

    dp_out = os.path.join(workdir, "unet_dp")
    dp = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(dp_ranks), "-m", "latentsync_tpu_torch.scripts.train_unet", "--config",
         paths["overfit"], "--max-steps", "2", "--output-dir", dp_out, "--log-every", "1",
         "--device", device], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=REPO))
    try:
        out = os.path.join(workdir, "unet_run")
        recs, wall = run_cli("train_unet", ["--config", paths["unet"], "--max-steps",
                                            str(steps), "--output-dir", out] + common)
        series = loss_series(recs)
        vals = [r for r in recs if "val_step" in r]
        ckpts = sorted(d for d in os.listdir(out) if d.startswith("step_"))
        r_recs, r_wall = run_cli("train_unet", ["--config", paths["unet"], "--max-steps",
                                                str(steps + resume_steps), "--output-dir", out,
                                                "--resume"] + common)
        resumed = [r for r in r_recs if "resumed_from" in r]
        r_series = loss_series(r_recs)
        report["unet"] = {"wall_s": wall, "loss": series, "checkpoints": ckpts,
                          "validations": vals, "resume": {"wall_s": r_wall,
                                                          "resumed": resumed,
                                                          "loss": r_series}}
        checks["unet_checkpoint"] = bool(ckpts)
        checks["unet_resumed"] = bool(resumed) and resumed[0]["step"] >= steps \
            and bool(r_series) and r_series[-1][0] == steps + resume_steps
        checks["unet_scored_validation"] = bool(vals) and all(
            os.path.isfile(v["val_video"]) and v["val_sync_conf"] is not None
            and np.isfinite(v["val_sync_conf"]) for v in vals)
        diff = video_diff(vals[0]["val_video"], vals[-1]["val_video"]) \
            if len(vals) >= 2 else None
        report["unet"]["val_video_diff"] = diff
        checks["unet_val_videos_differ"] = diff is not None and diff > 0.01
        report["unet"]["loss_decreasing"] = checks["unet_loss_decreasing"] = decreasing(series)

        out = os.path.join(workdir, "unet_overfit_run")
        recs, wall = run_cli("train_unet", ["--config", paths["overfit"], "--max-steps",
                                            str(overfit_steps), "--output-dir", out,
                                            "--overfit"] + common)
        o_series = loss_series(recs)
        report["unet_overfit"] = {"wall_s": wall, "loss": o_series}
        checks["unet_overfit_loss_falls"] = bool(o_series) and o_series[-1][1] < 0.5 \
            and o_series[-1][1] < 0.5 * o_series[0][1]

        out = os.path.join(workdir, "unet_fullstack_run")
        recs, wall = run_cli("train_unet", ["--config", paths["fullstack"], "--max-steps",
                                            str(fullstack_steps), "--output-dir", out] + common)
        comps = [r["loss_components"] for r in recs if "loss_components" in r]
        report["unet_fullstack"] = {"wall_s": wall, "loss": loss_series(recs),
                                    "loss_components": comps}
        checks["unet_fullstack_components"] = bool(comps) and all(
            k in comps[-1] and np.isfinite(comps[-1][k])
            for k in ("recon", "perceptual", "trepa", "sync"))

        out = os.path.join(workdir, "syncnet_run")
        sync_common = ["--config", paths["syncnet"], "--output-dir", out,
                       "--validation-steps", str(save_every)] + common
        recs, wall = run_cli("train_syncnet", sync_common + ["--max-steps", str(steps)])
        s_series = loss_series(recs)
        ckpts = sorted(d for d in os.listdir(out) if d.startswith("step_"))
        r_recs, r_wall = run_cli("train_syncnet", sync_common + [
            "--max-steps", str(steps + resume_steps), "--resume"])
        resumed = [r for r in r_recs if "resumed_from" in r]
        report["syncnet"] = {"wall_s": wall, "loss": s_series, "checkpoints": ckpts,
                             "sat_frac": [(r["step"], r["sat_frac"]) for r in recs
                                          if "sat_frac" in r],
                             "validations": [r for r in recs if "val_step" in r],
                             "resume": {"wall_s": r_wall, "resumed": resumed,
                                        "loss": loss_series(r_recs)}}
        checks["syncnet_checkpoint"] = bool(ckpts)
        checks["syncnet_resumed"] = bool(resumed) and resumed[0]["step"] >= steps
        sat = report["syncnet"]["sat_frac"]
        # every sample pinned at the BCE clip means zero gradient
        checks["syncnet_live_gradients"] = bool(sat) and sat[-1][1] < 0.5
        report["syncnet"]["loss_decreasing"] = checks["syncnet_loss_decreasing"] = \
            decreasing(s_series)
    finally:
        stdout, stderr = dp.communicate(timeout=1800)
    d_recs = _records(stdout)
    report["data_parallel"] = {"exit": dp.returncode, "records": d_recs}
    checks["data_parallel"] = dp.returncode == 0 and any(
        r.get("data_parallel", {}).get("dp") == dp_ranks for r in d_recs
        if isinstance(r.get("data_parallel"), dict)) \
        and [r["step"] for r in d_recs if "loss" in r] == [1, 2]
    if dp.returncode:
        report["data_parallel"]["stderr"] = stderr[-3000:]
    report["checks"] = checks
    return report, all(checks.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="", help="write the whole report here (JSON)")
    p.add_argument("--workdir", default="", help="clips, configs and runs (a temporary "
                                                 "directory by default)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--resume-steps", type=int, default=10)
    p.add_argument("--overfit-steps", type=int, default=45)
    p.add_argument("--fullstack-steps", type=int, default=4)
    p.add_argument("--dp-ranks", type=int, default=0,
                   help="ranks of the data-parallel run (default: every card, or 2 on the CPU)")
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("train_artifact", args.device):
        return 2
    import torch

    dp_ranks = args.dp_ranks or (torch.cuda.device_count() if args.device.startswith("cuda")
                                 else 2)
    with contextlib.ExitStack() as stack:
        workdir = args.workdir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(workdir, exist_ok=True)
        report, ok = run(workdir, args.device, args.steps, args.resume_steps,
                         args.overfit_steps, args.fullstack_steps, dp_ranks,
                         args.log_every)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(report, ok=ok), f, indent=1)
    print(json.dumps({"train_artifact": args.out or None, "ok": ok, **report["checks"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
