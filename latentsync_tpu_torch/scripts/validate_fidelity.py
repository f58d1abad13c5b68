"""One-command fidelity gate for the fast inference modes (the port's
counterpart of ``scripts/validate_fidelity.py``).

    python -m latentsync_tpu_torch.scripts.validate_fidelity --video V --audio A \\
        [--unet-ckpt ...] [--vae-ckpt ...] [--whisper-ckpt ...] \\
        [--syncnet-ckpt checkpoints/auxiliary/syncnet_v2.model] \\
        [--fast "int8,deepcache=2:1,cfg=0:0.5"] [--tolerance 0.02] [--ladder] \\
        [--device cpu]

The production fast path (int8 convolutions, DeepCache step caching, the
CFG guidance interval) is gated statistically, not bit for bit:
``BASELINE.md`` requires the SyncNet confidence within 2 % of the exact
trajectory's. The clip is rendered with every switch off (the exact
trajectory) and with the ``--fast`` configuration, from the same seed;
both are scored by the SyncNet scorer (ref:eval/eval_sync_conf.py), and
the run exits nonzero where |conf_fast − conf_exact| > tolerance ·
|conf_exact|. ``--ladder`` walks ``LADDER`` from the most aggressive rung
and selects the first that passes. The port reads the switches at each
call, so one pipeline renders every mode, its switches set for each render.

Without real weights (the UNet and VAE files and the scorer's) the run
still goes through the whole protocol, but its confidences are noise: the
JSON says ``"weights": "random"`` and the gate ``INCONCLUSIVE``. A
``step_*.pt`` file of the port's trainer as ``--unet-ckpt`` counts as
trained-tiny weights (the JAX script's Orbax step directory): the
deviation metrics then mean something, the confidence gate does not. The
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

# most aggressive → safest (the JAX script's ladder)
LADDER = [
    "int8,deepcache=5:1:enc:2,cfg=0:0.5",
    "int8,deepcache=4:1:enc:2,cfg=0:0.5",
    "int8,deepcache=4:1:enc:1,cfg=0:0.5",
    "int8,deepcache=4:1:enc,cfg=0:0.5",
    "int8,deepcache=3:1:enc,cfg=0:0.5",
    "int8,deepcache=2:1,cfg=0:0.5",
    "int8",
]
INCONCLUSIVE = "INCONCLUSIVE (SyncNet evaluator weights absent)"


def _clear_fast_env() -> None:
    os.environ["LATENTSYNC_INT8"] = "0"
    os.environ["LATENTSYNC_DEEPCACHE"] = "0"
    os.environ["LATENTSYNC_CFG_INTERVAL"] = ""


def _is_trainer_step(path: str) -> bool:
    return bool(re.fullmatch(r"step_\d+\.pt", os.path.basename(path or ""))) \
        and os.path.isfile(path)


def pixel_delta(path_a: str, path_b: str) -> float:
    """Mean |Δ| in uint8 codes between two renders of the same seed: the
    weight-free deviation of a rung from the exact trajectory."""
    import numpy as np

    from ..utils.media import read_video

    a = np.asarray(read_video(path_a, change_fps=False), np.float32)
    b = np.asarray(read_video(path_b, change_fps=False), np.float32)
    n = min(len(a), len(b))
    return float(np.mean(np.abs(a[:n] - b[:n])))


def main(argv=None) -> int:
    from .inference import add_model_args, build_pipeline, no_card, set_fast_env

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", required=True)
    p.add_argument("--audio", required=True)
    add_model_args(p)
    p.add_argument("--syncnet-ckpt", default="checkpoints/auxiliary/syncnet_v2.model")
    p.add_argument("--fast", default=LADDER[0],
                   help="fast-mode spec: comma list of int8 / deepcache=I:d[:enc[:k]] / "
                        "cfg=lo:hi")
    p.add_argument("--ladder", action="store_true",
                   help="walk the ladder most aggressive first and select the first rung "
                        "that passes the gate (ignores --fast)")
    p.add_argument("--tolerance", type=float, default=0.02,
                   help="relative SyncNet-confidence tolerance (BASELINE.md)")
    p.add_argument("--inference-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=1247)
    p.add_argument("--window-batch", type=int, default=2)
    p.add_argument("--workdir", default="validate_fidelity_out")
    p.add_argument("--out", default="", help="also write the result JSON to this path")
    args = p.parse_args(argv)
    if no_card("validate_fidelity", args.device):
        return 2
    os.makedirs(args.workdir, exist_ok=True)

    trained_tiny = _is_trainer_step(args.unet_ckpt)
    have_weights = (os.path.isfile(args.unet_ckpt) and os.path.isfile(args.vae_ckpt)
                    and not trained_tiny)
    unet_ckpt = args.unet_ckpt
    if trained_tiny:
        args.unet_ckpt = ""
    pipe = build_pipeline(args)
    if trained_tiny:
        import torch

        state = torch.load(unet_ckpt, map_location="cpu", weights_only=True)
        pipe.unet.load_state_dict(state["params"])

    def render(mode: str, spec: str) -> str:
        if spec:
            set_fast_env(spec)
        else:
            _clear_fast_env()
        out_path = os.path.join(args.workdir, f"{mode}.mp4")
        try:
            pipe(video_path=args.video, audio_path=args.audio, video_out_path=out_path,
                 num_inference_steps=args.inference_steps,
                 guidance_scale=args.guidance_scale, seed=args.seed,
                 window_batch=args.window_batch)
        finally:
            _clear_fast_env()
        return out_path

    from ..eval.sync_eval import evaluator_from_file

    evaluator, sync_weights = evaluator_from_file(args.syncnet_ckpt, args.device)
    weights = "pretrained" if have_weights and sync_weights == "pretrained" else "random"
    tag = "trained-tiny" if trained_tiny else weights

    def conf_of(path: str) -> float:
        return evaluator.evaluate(path)[2]

    exact_path = render("exact", "")
    conf_exact = conf_of(exact_path)

    def gate(spec: str, mode: str = "fast"):
        fast_path = render(mode, spec)
        conf_fast = conf_of(fast_path)
        rel = abs(conf_fast - conf_exact) / abs(conf_exact) if conf_exact else float("inf")
        return conf_fast, rel, rel <= args.tolerance, pixel_delta(exact_path, fast_path)

    def emit(payload: dict) -> None:
        blob = json.dumps(payload)
        print(blob, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(blob + "\n")

    if args.ladder:
        rungs, chosen = [], None
        for i, spec in enumerate(LADDER):
            conf_fast, rel, passed, pix = gate(spec, f"rung{i}")
            rungs.append({"spec": spec, "conf": round(conf_fast, 4), "rel_delta": round(rel, 4),
                          "pixel_delta": round(pix, 4), "pass": bool(passed)})
            if passed and weights == "pretrained":
                chosen = spec
                break
        emit({"mode": "ladder", "conf_exact": round(conf_exact, 4), "rungs": rungs,
              "selected": chosen or "exact", "tolerance": args.tolerance, "weights": tag,
              "gate": (("PASS" if chosen else "FAIL (exact only)")
                       if weights == "pretrained" else INCONCLUSIVE)})
        return 1 if weights == "pretrained" and chosen is None else 0

    conf_fast, rel, passed, pix = gate(args.fast)
    emit({"fast_mode": args.fast, "conf_exact": round(conf_exact, 4),
          "conf_fast": round(conf_fast, 4), "rel_delta": round(rel, 4),
          "pixel_delta": round(pix, 4), "tolerance": args.tolerance, "weights": tag,
          "gate": ("PASS" if passed else "FAIL") if weights == "pretrained" else INCONCLUSIVE})
    return 1 if weights == "pretrained" and not passed else 0


if __name__ == "__main__":
    sys.exit(main())
