"""Crop and align faces FFHQ-style from 68 landmarks.

    python -m latentsync_tpu_torch.scripts.crop_align_face -i IN_DIR -o OUT_DIR \
        [--output_size 512] [--transform_size 4096] [--enable_padding] [--device cuda]

Counterpart of ``scripts/crop_align_face.py``: the 68 points come from the
port's default landmark detector (``utils/image_processor.py``
``default_landmark_detector``: the FAN of ``$LATENTSYNC_FAN_CKPT`` behind
S3FD boxes, else the packaged fallback FAN behind the Haar box stage) on
``--device`` (the card unless ``cpu``), and the crop is
``utils/ffhq_align.py``'s. Each input ``*.png`` / ``*.jpg`` / ``*.jpeg``
becomes ``<name>.png``; an image without 68 landmarks is skipped.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--in_dir", "-i", required=True)
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--output_size", type=int, default=512)
    p.add_argument("--transform_size", type=int, default=4096)
    p.add_argument("--enable_padding", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    from ..utils.ffhq_align import ffhq_align_face
    from ..utils.image_processor import default_landmark_detector

    detector = default_landmark_detector(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.in_dir, "*.[jp][pn]g"))
                   + glob.glob(os.path.join(args.in_dir, "*.jpeg")))
    done = 0
    for path in paths:
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        lm = np.asarray(detector(img))
        if lm.shape[0] < 68:
            print(f"skip {os.path.basename(path)}: no dense landmarks")
            continue
        aligned = ffhq_align_face(img, lm, output_size=args.output_size,
                                  transform_size=args.transform_size,
                                  enable_padding=args.enable_padding)
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        cv2.imwrite(os.path.join(args.out_dir, name), cv2.cvtColor(aligned, cv2.COLOR_RGB2BGR))
        done += 1
    print(f"aligned {done}/{len(paths)} images into {args.out_dir}")


if __name__ == "__main__":
    main()
