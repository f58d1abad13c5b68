"""Registries of architectures, losses, metrics, schedules and datasets
(basicsr parity).

Counterpart of ``latentsync_tpu/training/registry.py`` (ref:basicsr/utils/
registry.py): the same registries under the same names, each holding the
port's own class or function, so an option file names the same things in
both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """name → class or function (ref:basicsr/utils/registry.py)."""

    def __init__(self, name: str):
        self.name = name
        self._map: Dict[str, Any] = {}

    def register(self, obj: Optional[Callable] = None, name: Optional[str] = None):
        if obj is None:
            return lambda o: self.register(o, name)
        key = name or obj.__name__
        if key in self._map:
            raise KeyError(f"{key} already registered in {self.name}")
        self._map[key] = obj
        return obj

    def get(self, name: str):
        if name not in self._map:
            raise KeyError(f"{name} not found in {self.name} registry "
                           f"(have: {sorted(self._map)})")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map


ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
DATASET_REGISTRY = Registry("dataset")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
SCHEDULER_REGISTRY = Registry("scheduler")


def register_builtin():
    """Register the port's archs, losses, metrics, schedules and the FFHQ
    dataset once, under the JAX package's names."""
    from ..models import codeformer as cf
    from ..models import perceptual, syncnet, unet3d, vae
    from . import losses as L
    from .degradations import FFHQBlindSource
    from .lr_schedules import cosine_annealing_restart_lr, multistep_restart_lr
    from .metrics import psnr, ssim

    for registry, entries in [
        (ARCH_REGISTRY, [("VQAutoEncoder", cf.VQAutoEncoder), ("CodeFormer", cf.CodeFormer),
                         ("VQGANDiscriminator", cf.VQGANDiscriminator),
                         ("UNet3DConditionModel", unet3d.UNet3DConditionModel),
                         ("AutoencoderKL", vae.AutoencoderKL),
                         ("StableSyncNet", syncnet.StableSyncNet), ("LPIPS", perceptual.LPIPS)]),
        (LOSS_REGISTRY, [("cosine_bce", L.cosine_bce_loss), ("charbonnier", L.charbonnier),
                         ("tv", L.total_variation), ("gan", L.gan_loss), ("l1", L.masked_l1)]),
        (METRIC_REGISTRY, [("psnr", psnr), ("ssim", ssim)]),
        # basicsr option-file type names (ref:options/*.yml scheduler.type)
        (SCHEDULER_REGISTRY, [("MultiStepRestartLR", multistep_restart_lr),
                              ("CosineAnnealingRestartLR", cosine_annealing_restart_lr)]),
        # basicsr dataset type name (ref:options/CodeFormer_stage2.yml:10)
        (DATASET_REGISTRY, [("FFHQBlindDataset", FFHQBlindSource)]),
    ]:
        for name, obj in entries:
            if name not in registry:
                registry.register(obj, name)


def build_from_options(registry: Registry, opt: Dict[str, Any]):
    """basicsr-style: {'type': Name, ...kwargs} → instance."""
    opt = dict(opt)
    cls = registry.get(opt.pop("type"))
    return cls(**opt)
