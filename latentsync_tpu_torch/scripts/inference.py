"""Lip-sync one clip from the command line.

    python -m latentsync_tpu_torch.scripts.inference --video V --audio A --out OUT \
        [--data-path bundle.npz] [--unet-config stage2.yaml] \
        [--unet-ckpt latentsync_unet.pt] [--vae-ckpt sd-vae-ft-mse.pt] \
        [--whisper-ckpt tiny.pt] [--fast [SPEC]] [--device cuda]

Counterpart of ``scripts/inference.py``. It reads the checkpoint files the
JAX package's CLI reads: the LatentSync UNet ``.pt`` (its state dict, in a
``state_dict`` wrapper or not), the diffusers SD-VAE ``.pt`` (either
spelling of the mid-block attention's keys) and OpenAI's whisper ``.pt``
(``dims`` + ``model_state_dict``). A file that is missing leaves its model
with seeded random weights (``init_random_``). ``--fast`` sets the
reference's FLOP-cut and int8 switches from a comma list (``int8``,
``deepcache=I:d[:enc[:k]]``, ``cfg=lo:hi``); bare, it is the reference's
production point ``int8,deepcache=4:1:enc,cfg=0:0.5``. Runs on the card
unless ``--device cpu``. Prints one JSON line: ``out``, ``frames``,
``timings``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

FAST_DEFAULT = "int8,deepcache=4:1:enc,cfg=0:0.5"


def set_fast_env(spec: str) -> None:
    """A ``--fast`` spec such as "int8,deepcache=2:1,cfg=0:0.5" → the
    switches ``LATENTSYNC_INT8``, ``LATENTSYNC_DEEPCACHE`` and
    ``LATENTSYNC_CFG_INTERVAL`` (each reset first); an unknown token exits."""
    os.environ["LATENTSYNC_INT8"] = "0"
    os.environ["LATENTSYNC_DEEPCACHE"] = "0"
    os.environ["LATENTSYNC_CFG_INTERVAL"] = ""
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if part == "int8":
            os.environ["LATENTSYNC_INT8"] = "1"
        elif part.startswith("deepcache="):
            os.environ["LATENTSYNC_DEEPCACHE"] = part.split("=", 1)[1]
        elif part.startswith("cfg="):
            os.environ["LATENTSYNC_CFG_INTERVAL"] = part.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown fast-mode token: {part!r}")


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_unet(unet, path: str) -> None:
    """The LatentSync UNet state dict with the reference's tolerant load: a
    conv_in / conv_out of another channel count and audio k / v of another
    width are dropped, positional-encoding tables (recomputed) are
    skipped, and missing entries keep their initial values. A key the
    model does not have raises."""
    sd = _torch_load(path)
    sd = sd.get("state_dict", sd)
    own = unet.state_dict()
    keep = {}
    for k, v in sd.items():
        if "pos_encoder" in k:
            continue
        if k in own and own[k].shape != v.shape and (
                k.startswith(("conv_in.", "conv_out.")) or ".attn2.to_k." in k
                or ".attn2.to_v." in k):
            continue
        keep[k] = v
    missing, unexpected = unet.load_state_dict(keep, strict=False)
    if unexpected:
        raise ValueError(f"{path}: UNet keys the model does not have: {unexpected[:10]}")


_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def _load_vae(vae, path: str) -> None:
    """A diffusers AutoencoderKL state dict, with the mid-block attention
    under its current names (to_q / to_k / to_v / to_out.0) or its legacy
    ones (query / key / value / proj_attn, 1x1-conv or linear weights)."""
    sd = _torch_load(path)
    sd = sd.get("state_dict", sd)
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if "attentions" in parts and len(parts) >= 2 and parts[-2] in _VAE_ATTN:
            k = ".".join(parts[:-2] + [_VAE_ATTN[parts[-2]], parts[-1]])
            if v.dim() == 4:
                v = v[:, :, 0, 0]
        out[k] = v
    vae.load_state_dict(out)


def _whisper_file(path: str):
    """OpenAI's whisper checkpoint → (WhisperConfig, the encoder's state dict)."""
    from ..config import WhisperConfig

    ckpt = _torch_load(path)
    dims = ckpt.get("dims", {})
    cfg = WhisperConfig(n_mels=dims.get("n_mels", 80), n_audio_ctx=dims.get("n_audio_ctx", 1500),
                        n_audio_state=dims.get("n_audio_state", 384),
                        n_audio_head=dims.get("n_audio_head", 6),
                        n_audio_layer=dims.get("n_audio_layer", 4))
    sd = {k.removeprefix("encoder."): v for k, v in ckpt["model_state_dict"].items()
          if k.startswith("encoder.") and k != "encoder.positional_embedding"}
    return cfg, sd


def _isfile(path) -> bool:
    return bool(path) and os.path.isfile(path)


def build_pipeline(args, dtype=None):
    """The pipeline the arguments name: ``unet_config`` (a stage YAML, or
    the release config), ``unet_ckpt``, ``vae_ckpt``, ``whisper_ckpt`` and
    ``device``. Whisper is tiny or small by the UNet's cross-attention
    width, else an encoder of that width. `dtype`: bfloat16 on the card and
    float32 on the CPU unless given."""
    from ..audio.features import Audio2Feature
    from ..config import LatentSyncConfig, WhisperConfig, load_unet_config
    from ..models.unet3d import UNet3DConditionModel
    from ..models.vae import AutoencoderKL
    from ..models.whisper import WhisperEncoder
    from ..pipelines.lipsync import LipsyncPipeline
    from ..utils.convert import init_random_

    if getattr(args, "unet_ckpt", None) and os.path.isdir(args.unet_ckpt):
        raise ValueError(f"{args.unet_ckpt}: a trainer's checkpoint directory; the port reads "
                         "the LatentSync UNet .pt")
    config = load_unet_config(args.unet_config) if args.unet_config else LatentSyncConfig()
    cad = config.unet.cross_attention_dim
    if cad == 384:
        whisper_cfg = WhisperConfig.tiny()
    elif cad == 768:
        whisper_cfg = WhisperConfig.small()
    else:
        whisper_cfg = WhisperConfig(n_audio_state=cad, n_audio_head=max(1, cad // 8),
                                    n_audio_layer=1)
    whisper_sd = None
    if _isfile(args.whisper_ckpt):
        whisper_cfg, whisper_sd = _whisper_file(args.whisper_ckpt)
    whisper = WhisperEncoder(whisper_cfg)
    if whisper_sd is None:
        init_random_(whisper, seed=3)
    else:
        whisper.load_state_dict(whisper_sd)

    vae = AutoencoderKL(config.vae)
    if _isfile(args.vae_ckpt):
        _load_vae(vae, args.vae_ckpt)
    else:
        init_random_(vae, seed=1)

    unet = init_random_(UNet3DConditionModel(config.unet), seed=2)
    if _isfile(args.unet_ckpt):
        _load_unet(unet, args.unet_ckpt)

    device = torch.device(args.device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    audio_encoder = Audio2Feature(whisper.to(device, dtype).eval(),
                                  num_frames=config.data.num_frames,
                                  audio_feat_length=config.data.audio_feat_length)
    return LipsyncPipeline(unet, vae, audio_encoder, config, dtype=dtype, device=device)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The model flags both CLIs take."""
    p.add_argument("--unet-config", default="")
    p.add_argument("--unet-ckpt", default="checkpoints/latentsync_unet.pt")
    p.add_argument("--vae-ckpt", default="checkpoints/sd-vae-ft-mse.pt")
    p.add_argument("--whisper-ckpt", default="checkpoints/whisper/tiny.pt")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def no_card_message(prog: str, device: str):
    """The message a run on `device` gives where it is the card and there is
    none, else None."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return (f"{prog}: no CUDA device (torch.cuda.is_available() is false); pass "
                "--device cpu to run on the CPU")
    return None


def no_card(prog: str, device: str) -> bool:
    """True, with the message on stderr, where `device` is the card and
    there is none."""
    message = no_card_message(prog, device)
    if message:
        print(message, file=sys.stderr)
    return message is not None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", required=True, dest="video_path")
    p.add_argument("--audio", required=True, dest="audio_path")
    p.add_argument("--out", required=True, dest="video_out_path")
    add_model_args(p)
    p.add_argument("--inference-steps", type=int, default=20)
    p.add_argument("--guidance-scale", type=float, default=1.5)
    p.add_argument("--seed", type=int, default=1247)
    p.add_argument("--resolution", type=int, default=0)
    p.add_argument("--data-path", default=None, help="precomputed affine bundle (.npz)")
    p.add_argument("--window-batch", type=int, default=2)
    p.add_argument("--fast", default=None, nargs="?", const=FAST_DEFAULT,
                   help="comma list of int8 / deepcache=I:d[:enc[:k]] / cfg=lo:hi; bare: "
                        f"{FAST_DEFAULT}. Omit for the exact trajectory (the switches in "
                        "the environment still hold)")
    args = p.parse_args(argv)
    if no_card("inference", args.device):
        return 2
    if args.fast is not None:
        set_fast_env(args.fast)
    pipe = build_pipeline(args)
    out = pipe(video_path=args.video_path, audio_path=args.audio_path,
               video_out_path=args.video_out_path, num_inference_steps=args.inference_steps,
               guidance_scale=args.guidance_scale, seed=args.seed, data_path=args.data_path,
               window_batch=args.window_batch, height=args.resolution or None)
    print(json.dumps({"out": out.video_path, "frames": out.num_frames,
                      "timings": out.elapsed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
