"""Typed configuration tree for latentsync_tpu_torch.

The same dataclasses, fields and defaults as ``latentsync_tpu/config.py``
(the upstream stage-2 LatentSync 1.5 operating point), so a config tree
means the same model in both packages. PyYAML is imported only by the
loaders.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


def _freeze(x):
    if isinstance(x, list):
        return tuple(_freeze(v) for v in x)
    return x


@dataclass(frozen=True)
class SchedulerConfig:
    """DDIM scheduler constants (ref:configs/scheduler_config.json)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = False
    prediction_type: str = "epsilon"
    timestep_spacing: str = "leading"


@dataclass(frozen=True)
class MotionModuleConfig:
    """Temporal transformer config (ref:configs/unet/stage2.yaml:93-106)."""

    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 24
    temporal_attention_dim_div: int = 1
    zero_initialize: bool = True


@dataclass(frozen=True)
class UNet3DConfig:
    """Audio-conditioned 3D UNet (ref:latentsync/models/unet.py:39-241,
    ref:configs/unet/stage2.yaml model section)."""

    sample_size: int = 64
    in_channels: int = 13  # 4 noise + 1 mask + 4 masked + 4 ref
    out_channels: int = 4
    center_input_sample: bool = False
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    mid_block_type: str = "UNetMidBlock3DCrossAttn"
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    act_fn: str = "silu"
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 384
    attention_head_dim: int = 8
    use_inflated_groupnorm: bool = False
    resnet_time_scale_shift: str = "default"
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_module_decoder_only: bool = False
    motion_module: MotionModuleConfig = field(default_factory=MotionModuleConfig)
    add_audio_layer: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclass(frozen=True)
class VAEConfig:
    """SD AutoencoderKL, `stabilityai/sd-vae-ft-mse` shape
    (ref:scripts/inference.py:56-58 — scaling 0.18215, shift 0)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0

    @property
    def scale_factor(self) -> int:
        """Spatial downsample factor (2**(n_blocks-1)); 8 for SD."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper audio encoder dims (ref:latentsync/whisper/whisper/model.py:15-27).

    Defaults are whisper-tiny, selected by cross_attention_dim==384
    (ref:scripts/inference.py:42-47).
    """

    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    # text decoder dims (ref:whisper/model.py:15-27; multilingual vocab)
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls()

    @classmethod
    def small(cls) -> "WhisperConfig":
        return cls(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                   n_text_state=768, n_text_head=12, n_text_layer=12)


@dataclass(frozen=True)
class AudioDSPConfig:
    """Wav2Lip-style mel DSP constants for SyncNet (ref:configs/audio.yaml)."""

    num_mels: int = 80
    n_fft: int = 800
    hop_size: int = 200
    win_size: int = 800
    sample_rate: int = 16000
    fmin: float = 55.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    preemphasize: bool = True
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    max_abs_value: float = 4.0
    symmetric_mels: bool = True
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True
    rescale: bool = True
    rescaling_max: float = 0.9


@dataclass(frozen=True)
class SyncNetEncoderConfig:
    """One DownEncoder2D tower (ref:latentsync/models/stable_syncnet.py:172,
    ref:configs/syncnet/syncnet_16_pixel_attn.yaml)."""

    in_channels: int
    block_out_channels: Tuple[int, ...]
    downsample_factors: Tuple[Any, ...]
    attn_blocks: Tuple[int, ...]
    dropout: float = 0.0


@dataclass(frozen=True)
class SyncNetConfig:
    audio_encoder: SyncNetEncoderConfig = field(
        default_factory=lambda: SyncNetEncoderConfig(
            in_channels=1,
            block_out_channels=(32, 64, 128, 256, 512, 1024, 2048),
            downsample_factors=((2, 1), 2, 2, 1, 2, 2, (2, 3)),
            attn_blocks=(0, 0, 0, 1, 1, 0, 0),
        )
    )
    visual_encoder: SyncNetEncoderConfig = field(
        default_factory=lambda: SyncNetEncoderConfig(
            in_channels=48,
            block_out_channels=(64, 128, 256, 256, 512, 1024, 2048, 2048),
            downsample_factors=((1, 2), 2, 2, 2, 2, 2, 2, 2),
            attn_blocks=(0, 0, 0, 0, 1, 1, 0, 0),
        )
    )


@dataclass(frozen=True)
class DataConfig:
    """Operating-point constants (ref:configs/unet/stage2.yaml data section)."""

    num_frames: int = 16
    resolution: int = 256
    mask: str = "fix_mask"
    mask_image_path: str = ""
    audio_sample_rate: int = 16000
    video_fps: int = 25
    audio_feat_length: Tuple[int, int] = (2, 2)
    batch_size: int = 1
    train_fileslist: str = ""
    train_data_dir: str = ""
    val_fileslist: str = ""
    audio_embeds_cache_dir: str = ""
    audio_mel_cache_dir: str = ""
    val_video_path: str = ""
    val_audio_path: str = ""
    train_output_dir: str = ""
    num_workers: int = 0
    # SyncNet latent-space mode: visual tower eats VAE latents instead of
    # pixels (ref:configs/syncnet/syncnet_16_latent.yaml, train_syncnet.py:69-74)
    latent_space: bool = False
    num_val_samples: int = 2048


@dataclass(frozen=True)
class RunConfig:
    """Trainer knobs (ref:configs/unet/stage2.yaml run/optimizer sections)."""

    pixel_space_supervise: bool = True
    use_syncnet: bool = True
    sync_loss_weight: float = 0.05
    perceptual_loss_weight: float = 0.1
    recon_loss_weight: float = 1.0
    trepa_loss_weight: float = 10.0
    guidance_scale: float = 1.5
    inference_steps: int = 20
    trainable_modules: Tuple[str, ...] = ("motion_modules.", "attentions.")
    seed: int = 1247
    use_mixed_noise: bool = True
    mixed_noise_alpha: float = 1.0
    mixed_precision_training: bool = True
    enable_gradient_checkpointing: bool = True
    max_train_steps: int = 10_000_000
    lr: float = 1e-5
    max_grad_norm: float = 1.0
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    save_ckpt_steps: int = 10000
    resume_ckpt_path: str = ""


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the JAX package (data and model axes); kept
    so config trees load unchanged. The port lays its ranks out with
    ``parallel/mesh.py`` ``make_mesh(n_devices, model_parallel)``."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all remaining devices
    model_parallel: int = 1


@dataclass(frozen=True)
class LatentSyncConfig:
    """Top-level config tree."""

    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    audio_dsp: AudioDSPConfig = field(default_factory=AudioDSPConfig)
    syncnet: SyncNetConfig = field(default_factory=SyncNetConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# YAML / dict loading
# ---------------------------------------------------------------------------


def _build_dataclass(cls, data: Dict[str, Any]):
    """Recursively build a (frozen) dataclass from a plain dict, tolerating
    unknown keys (they are ignored, like OmegaConf merge did upstream)."""
    if data is None:
        return cls()
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            continue
        f = fields[key]
        ftype = f.type
        if dataclasses.is_dataclass(_resolve_type(ftype)) and isinstance(value, dict):
            kwargs[key] = _build_dataclass(_resolve_type(ftype), value)
        else:
            # YAML 1.1 parses "1e-4" (no dot) as a string — coerce scalars
            # to the field's declared numeric type
            decl = str(ftype)
            if isinstance(value, str):
                if decl.startswith("float") or isinstance(f.default, float):
                    try:
                        value = float(value)
                    except ValueError:
                        pass
                elif decl.startswith("int") or isinstance(f.default, int):
                    try:
                        value = int(value)
                    except ValueError:
                        pass
            kwargs[key] = _freeze(value)
    return cls(**kwargs)


_TYPE_REGISTRY = {}


def _resolve_type(tp):
    if isinstance(tp, str):
        if not _TYPE_REGISTRY:
            import sys

            mod = sys.modules[__name__]
            for name in dir(mod):
                obj = getattr(mod, name)
                if dataclasses.is_dataclass(obj):
                    _TYPE_REGISTRY[name] = obj
        return _TYPE_REGISTRY.get(tp, tp)
    return tp


def load_config(path: str) -> LatentSyncConfig:
    """Load a full config tree from YAML."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return _build_dataclass(LatentSyncConfig, data or {})


def load_unet_config(path: str) -> "LatentSyncConfig":
    """Load a reference-style stage YAML (model/data/run sections map onto
    unet/data/run). Accepts the upstream key layout
    (ref:configs/unet/stage2.yaml) so existing configs keep working."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    model = dict(data.get("model", {}))
    if "motion_module_kwargs" in model:
        model["motion_module"] = model.pop("motion_module_kwargs")
    run = dict(data.get("run", {}))
    run.update(data.get("optimizer", {}))
    run.update(data.get("ckpt", {}))
    tree = {
        "unet": model,
        "data": data.get("data", {}),
        "run": run,
    }
    # stage-2 trains against a frozen SyncNet whose dims the stage YAML
    # may pin (the reference passes a separate --syncnet_config_path;
    # here an optional `syncnet:` section rides the same file); smoke
    # configs may likewise shrink the VAE
    for section in ("syncnet", "vae"):
        if section in data:
            tree[section] = data[section]
    return _build_dataclass(LatentSyncConfig, tree)


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, sort_keys=False)
