"""Time of one stage-2 train step of a checkout of the port, on one NVIDIA GPU.

    python3 latentsync_tpu_torch/scripts/train_step_time.py [TREE]

Run as a file, so that TREE's package is the one imported: TREE (default:
the checkout that holds this file) is the root of a checkout of the port
whose ``chip_smoke.py`` has phase 11 (stage-2 training). The step is phase
11's: the full-width LatentSync 1.5 stage-2 UNet, the VAE, SyncNet, LPIPS
and TREPA on random seeded weights, batch 1, 16 frames at 256², the full
loss stack, the reference's switches at their defaults. Prints one JSON
line: the card's name and power limit, the host time of 5 steps after two
warm-ups and their median, the UNet forward + backward alone (the median of
3 steps without pixel-space supervision, less the median of 3 VAE encodes),
and the device kernels of one step (``torch.profiler``): their count, their
summed device ms, and the device ms of the flash route's backward by kernel
(``bwd_row_kernel`` and ``bwd_wide_kernel``; the first design's
``stats_kernel``, ``dq_kernel`` and ``dkdv_kernel``) and of the attention
core's ``LSE`` instantiations (the residual forward: ``ls_core::attn...true>``).
Two trees in one call compare on one card.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

FLASH_BWD_NAMES = ("bwd_row_kernel", "bwd_wide_kernel", "stats_kernel", "dq_kernel",
                   "dkdv_kernel")


def flash_kernel(name: str) -> bool:
    """A device kernel of the flash route's backward or residual forward."""
    if "at::" in name:
        return False
    return any(x in name for x in FLASH_BWD_NAMES) or ("ls_core::attn" in name
                                                       and "true>" in name)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0] if argv else Path(__file__).resolve().parents[2])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("train_step_time: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from latentsync_tpu_torch.config import LatentSyncConfig
    from latentsync_tpu_torch.models.perceptual import LPIPS
    from latentsync_tpu_torch.models.syncnet import StableSyncNet
    from latentsync_tpu_torch.models.unet3d import UNet3DConditionModel
    from latentsync_tpu_torch.models.vae import AutoencoderKL
    from latentsync_tpu_torch.models.videomae import TREPALoss, VideoViT, VideoViTConfig
    from latentsync_tpu_torch.ops import _build
    from latentsync_tpu_torch.training.unet_trainer import UNetTrainer
    from latentsync_tpu_torch.utils.convert import init_random_

    _build.build()
    _build.lib()
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    cfg = LatentSyncConfig()
    unet = init_random_(UNet3DConditionModel(cfg.unet), seed=cs.SEED).to(dev, bf)
    vae = init_random_(AutoencoderKL(cfg.vae), seed=cs.SEED + 2).to(dev, bf)
    master = copy.deepcopy(unet).float().train()
    del unet
    syncnet = init_random_(StableSyncNet(cfg.syncnet), seed=cs.SEED + 4).to(dev, bf)
    lpips = init_random_(LPIPS(), seed=cs.SEED + 5).to(dev, bf)
    vit = init_random_(VideoViT(VideoViTConfig(img_size=64, patch_size=16, embed_dim=64,
                                               depth=2, num_heads=4, mlp_ratio=4.0)),
                       seed=cs.SEED + 6).to(dev, bf)
    trainer = UNetTrainer(cfg, master, vae, syncnet, lpips, TREPALoss(vit), dtype=bf)
    recon = UNetTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, pixel_space_supervise=False)), master, vae, dtype=bf)
    batch = cs._train_batch(cfg)
    t, noise = trainer.draw(batch, 0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return time.time() - t0

    def encode():
        for key in ("gt_pixels", "masked_pixels", "ref_pixels"):
            trainer._encode(batch[key], 1, cfg.data.num_frames)

    with cs.configured("default"):
        for _ in range(2):
            timed(lambda: trainer.gradients(batch, t, noise))
        steps = [timed(lambda: trainer.gradients(batch, t, noise)) for _ in range(5)]
        enc = statistics.median(timed(encode) for _ in range(3))
        unet_fb = statistics.median(timed(lambda: recon.gradients(batch, t, noise))
                                    for _ in range(3)) - enc
        kernels = cs.device_kernels(lambda: trainer.gradients(batch, t, noise))
    flash = collections.Counter()
    for name, us in kernels:
        if flash_kernel(name):
            flash[name[:60]] += us / 1e3
    print(json.dumps({"tree": tree, "gpu": cs.gpu_line(), "step_s": steps,
                      "step_median_s": statistics.median(steps), "unet_fwd_bwd_s": unet_fb,
                      "device_kernels": len(kernels),
                      "device_ms": sum(us for _, us in kernels) / 1e3,
                      "flash_device_ms": dict(flash)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
