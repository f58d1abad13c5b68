"""Inpaint a masked region of a face with CodeFormer (w = 0).

    python -m latentsync_tpu_torch.scripts.inference_inpainting --input FACE.png \
        --out OUT_DIR [--mask MASK.png] [--ckpt codeformer_inpainting.pth] [--device cuda]

Counterpart of ``scripts/inference_inpainting.py``: the face is resized to
512², the mask's white pixels (by default the generated mouth-region mask of
``utils/image_processor.py``) are zeroed in the normalised input, the
full-width CodeFormer (bf16, f32 norms) fills them from its codebook prior,
and only the masked pixels of its output replace the input's. Without a
checkpoint the weights are seeded random. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .inference_codeformer import build_codeformer, to_image


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--mask", default="", help="white = region to inpaint; "
                   "defaults to a generated mouth-region mask")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default="checkpoints/codeformer_inpainting.pth")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    from ..utils.image_processor import _generated_mouth_mask

    device = torch.device(args.device)
    model = build_codeformer(args.ckpt, device)
    os.makedirs(args.out, exist_ok=True)
    img = cv2.resize(cv2.cvtColor(cv2.imread(args.input), cv2.COLOR_BGR2RGB), (512, 512))
    if args.mask and os.path.isfile(args.mask):
        mask = cv2.resize(cv2.imread(args.mask, cv2.IMREAD_GRAYSCALE), (512, 512))
        mask = mask.astype(np.float32) / 255.0
    else:
        mask = 1.0 - _generated_mouth_mask(512)[:, :, 0]
    x = (img.astype(np.float32) / 127.5 - 1.0) * (1.0 - mask[:, :, None])
    with torch.inference_mode():
        y, _, _ = model(torch.from_numpy(x).permute(2, 0, 1)[None].to(device), w=0.0)
    y = to_image(y).astype(np.float32)
    out = (y * mask[:, :, None] + img * (1 - mask[:, :, None])).astype(np.uint8)
    dst = os.path.join(args.out, os.path.basename(args.input))
    cv2.imwrite(dst, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
    print(f"inpainted → {dst}")


if __name__ == "__main__":
    main()
