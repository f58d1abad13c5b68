"""Avatar onboarding: video → affine bundle (and, with a VAE, its latents).

    python -m latentsync_tpu_torch.scripts.prepare_video --video avatar.mp4 \
        --avatar-id alice --store avatars [--vae-ckpt vae.pt] [--device cuda]

Copies the video into the store as ``<avatar-id>.mp4`` and writes
``<avatar-id>.npz`` ({faces, boxes, affine_matrices}) from the FAN face
path (``ImageProcessor.affine_transform_batch`` with the default landmark
detector: ``$LATENTSYNC_FAN_CKPT``, else the packaged fallback FAN). With
``--vae-ckpt`` (a state dict of the port's VAE: ``.pth`` / ``.pt``, or an
``.npz`` of its names or of the JAX package's tree) it also writes
``<avatar-id>_latents.npz`` (``LipsyncPipeline.precompute_avatar_latents``),
so that requests for the avatar skip the VAE encode. The VAE runs in
bfloat16, the serving pipeline's dtype: a pipeline whose VAE weights are in
another dtype reads the artifact as stale and encodes anew. The video is
read at 25 fps, as requests read it. Runs on the card unless ``--device
cpu``. Prints one JSON line of the paths written and the seconds each stage
took.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", required=True)
    p.add_argument("--avatar-id", required=True)
    p.add_argument("--store", default=os.path.join(tempfile.gettempdir(), "avatars"))
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--vae-ckpt", default=None,
                   help="also precompute the avatar's VAE latents (masked and reference)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..serving.artifacts import generate_affine_bundle
    from ..utils.image_processor import ImageProcessor
    from .inference import no_card

    if no_card("prepare_video", args.device):
        return 2
    device = torch.device(args.device)
    os.makedirs(args.store, exist_ok=True)
    video_dst = os.path.join(args.store, args.avatar_id + ".mp4")
    if os.path.abspath(args.video) != os.path.abspath(video_dst):
        shutil.copy(args.video, video_dst)
    record = {"video": video_dst}

    t0 = time.time()
    processor = ImageProcessor(args.resolution, device=device)
    record["bundle"] = generate_affine_bundle(
        processor, video_dst, os.path.join(args.store, args.avatar_id + ".npz"))
    record["faces_s"] = time.time() - t0

    if args.vae_ckpt:
        from ..config import LatentSyncConfig
        from ..models.vae import AutoencoderKL
        from ..pipelines.lipsync import LipsyncPipeline
        from ..utils.convert import load_state_dict_file, vae_state_dict_from_flax

        t0 = time.time()
        cfg = LatentSyncConfig()
        vae = AutoencoderKL(cfg.vae)
        vae.load_state_dict(load_state_dict_file(args.vae_ckpt, vae_state_dict_from_flax))
        pipe = LipsyncPipeline(None, vae, None, cfg, device=device,
                               landmark_detector=processor.landmark_detector)
        record["latents"] = pipe.precompute_avatar_latents(record["bundle"],
                                                           height=args.resolution)
        record["latents_s"] = time.time() - t0
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
