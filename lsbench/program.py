"""The system under test: the port's ``LipsyncPipeline`` built from a
configuration file, with weights made by ``weights.fill_`` on the device."""

from __future__ import annotations

import os

import torch

from .weights import fill_

# the switches a configuration states; each is set for the run, an unset
# one to its default, so the caller's environment changes nothing
SWITCHES = ("LATENTSYNC_INT8", "LATENTSYNC_INT8_DENSE", "LATENTSYNC_DEEPCACHE",
            "LATENTSYNC_CFG_INTERVAL", "LATENTSYNC_FUSED_XATTN", "LATENTSYNC_PALLAS_GN",
            "LATENTSYNC_FUSED_ATTN", "LATENTSYNC_FUSED_FFN", "LATENTSYNC_RESTORE")


def apply_switches(config: dict) -> None:
    env = config.get("env", {})
    unknown = set(env) - set(SWITCHES)
    if unknown:
        raise ValueError(f"configuration {config['name']}: unknown switches {sorted(unknown)}")
    for k in SWITCHES:
        os.environ.pop(k, None)
        if env.get(k):
            os.environ[k] = env[k]


def dtype_of(config: dict, device) -> torch.dtype:
    if torch.device(device).type == "cpu":
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]


def port_config(config: dict):
    from latentsync_tpu_torch import config as pc

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    u = dict(config["unet"])
    mm = pc.MotionModuleConfig(**tup(u.pop("motion_module")))
    return pc.LatentSyncConfig(
        unet=pc.UNet3DConfig(motion_module=mm, **tup(u)),
        vae=pc.VAEConfig(**tup(config["vae"])),
        whisper=pc.WhisperConfig(**tup(config["whisper"])),
        data=pc.DataConfig(**tup(config["data"])))


def build_pipeline(config: dict, seed: int, device):
    """(pipeline, LatentSyncConfig): UNet and VAE in the configuration's
    type, whisper in float32, as the port serves them."""
    from latentsync_tpu_torch.audio.features import Audio2Feature
    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
    from latentsync_tpu_torch.models.vae import AutoencoderKL
    from latentsync_tpu_torch.models.whisper import WhisperEncoder
    from latentsync_tpu_torch.pipelines.lipsync import LipsyncPipeline

    cfg = port_config(config)
    dt = dtype_of(config, device)
    with torch.device("meta"):
        unet = UNet3DConditionModel(cfg.unet)
        vae = AutoencoderKL(cfg.vae)
        whisper = WhisperEncoder(cfg.whisper)
    fill_(unet, seed, "unet", device, dt)
    fill_(vae, seed, "vae", device, dt)
    fill_(whisper, seed, "whisper", device, torch.float32)
    pipe = LipsyncPipeline(unet, vae, Audio2Feature(whisper), cfg, dtype=dt,
                           device=torch.device(device))
    return pipe, cfg
