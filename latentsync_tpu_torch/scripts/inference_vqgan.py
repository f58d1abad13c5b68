"""Reconstruct images through the VQGAN autoencoder.

    python -m latentsync_tpu_torch.scripts.inference_vqgan -i IMG_DIR [-o OUT_DIR] \
        [--codebook_size 1024] [--ckpt_path vqgan.pth] [--device cuda]

Counterpart of ``scripts/inference_vqgan.py``: each ``*.png`` / ``*.jpg`` of
the input directory, resized to the model's 512², through the full-width
``VQAutoEncoder`` (bf16, norms in f32), saved as ``<name>_rec.png`` — the
quick check that converted VQGAN weights reconstruct faces. ``--ckpt_path``
is a ``.pth`` (wrappers unwrapped) or a JAX ``.npz`` tree; without one the
weights are seeded random (warned). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .inference_codeformer import SEED, to_image


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--test_path", "-i", required=True)
    p.add_argument("--save_root", "-o", default="./results/vqgan_rec")
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    from ..models import codeformer as cf
    from ..utils.convert import (codeformer_state_dict_from_flax, init_random_,
                                 load_state_dict_file)

    device = torch.device(args.device)
    model = cf.VQAutoEncoder(codebook_size=args.codebook_size)
    if args.ckpt_path and os.path.isfile(args.ckpt_path):
        model.load_state_dict(load_state_dict_file(args.ckpt_path,
                                                   codeformer_state_dict_from_flax))
    else:
        print("WARNING: no checkpoint — reconstructions use RANDOM weights")
        init_random_(model, SEED)
    model = cf.cast_floating_(model.eval(), torch.bfloat16).to(device)

    os.makedirs(args.save_root, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(args.test_path, "*.[jp][pn]g"))):
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (model.img_size, model.img_size))
        x = torch.from_numpy(img.astype(np.float32) / 255.0 * 2.0 - 1.0)
        with torch.inference_mode():
            rec, _, _ = model(x.permute(2, 0, 1)[None].to(device))
        name = os.path.splitext(os.path.basename(path))[0] + "_rec.png"
        cv2.imwrite(os.path.join(args.save_root, name),
                    cv2.cvtColor(to_image(rec), cv2.COLOR_RGB2BGR))
        print(name)
    print(f"reconstructions in {args.save_root}")


if __name__ == "__main__":
    main()
