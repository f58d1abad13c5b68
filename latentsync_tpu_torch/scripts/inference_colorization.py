"""Colorize a grey face with CodeFormer (w = 0, the codebook prior alone).

    python -m latentsync_tpu_torch.scripts.inference_colorization --input FACE.png \
        --out OUT_DIR [--ckpt codeformer_colorization.pth] [--device cuda]

Counterpart of ``scripts/inference_colorization.py``: the input is read as
grey, resized to 512², repeated over three channels and restored by the
full-width CodeFormer with fuse connections at 32, 64 and 128 (the
colorization checkpoint's), in bf16 with f32 norms. Without a checkpoint
the weights are seeded random. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .inference_codeformer import build_codeformer, to_image, to_model


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default="checkpoints/codeformer_colorization.pth")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    device = torch.device(args.device)
    model = build_codeformer(args.ckpt, device, connect_list=("32", "64", "128"))
    os.makedirs(args.out, exist_ok=True)
    img = cv2.resize(cv2.imread(args.input, cv2.IMREAD_GRAYSCALE), (512, 512))
    rgb = np.repeat(img[:, :, None], 3, axis=2)
    with torch.inference_mode():
        y, _, _ = model(to_model(rgb, device), w=0.0)
    dst = os.path.join(args.out, os.path.basename(args.input))
    cv2.imwrite(dst, cv2.cvtColor(to_image(y), cv2.COLOR_RGB2BGR))
    print(f"colorized → {dst}")


if __name__ == "__main__":
    main()
