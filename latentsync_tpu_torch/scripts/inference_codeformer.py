"""Restore the faces of images, a directory of images or an ``.mp4`` with CodeFormer.

    python -m latentsync_tpu_torch.scripts.inference_codeformer --input IMG_DIR_OR_MP4 \
        --out OUT_DIR [-w 0.5] [--ckpt codeformer.pth] [--device cuda]

Counterpart of ``scripts/inference_codeformer.py``: each face is aligned to
the FFHQ 512 template (``utils/face_restore_helper.py``), restored by the
full-width CodeFormer in bf16 (its norms in f32), and pasted back. ``-w`` is
the fidelity weight in [0, 1]. ``--ckpt`` is a released ``codeformer.pth``
(``params_ema`` / ``params`` / ``state_dict`` wrappers are unwrapped) or an
``.npz`` of the JAX package's parameter tree; without one the model has
seeded random weights. Video is read and written through ``utils/media.py``
(OpenCV where there is no ffmpeg) at 25 fps. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

SEED = 0


def build_codeformer(ckpt: str, device, **kw):
    """``CodeFormer(**kw)`` with the weights of `ckpt` where that file
    exists, else seeded random ones; bf16 with f32 norms, eval mode, on
    `device`."""
    from ..models import codeformer as cf
    from ..utils.convert import (codeformer_state_dict_from_flax, init_random_,
                                 load_state_dict_file)

    model = cf.CodeFormer(**kw)
    if ckpt and os.path.isfile(ckpt):
        model.load_state_dict(load_state_dict_file(ckpt, codeformer_state_dict_from_flax))
    else:
        print(f"no checkpoint at {ckpt!r}: seeded random weights")
        init_random_(model, SEED)
    return cf.cast_floating_(model.eval(), torch.bfloat16).to(device)


def to_model(img_rgb: np.ndarray, device) -> torch.Tensor:
    """uint8 (H, W, 3) → (1, 3, H, W) in [-1, 1] on `device`."""
    x = torch.from_numpy(img_rgb.astype(np.float32) / 127.5 - 1.0)
    return x.permute(2, 0, 1)[None].to(device)


def to_image(y: torch.Tensor) -> np.ndarray:
    """(1, 3, H, W) in [-1, 1] → uint8 (H, W, 3)."""
    y = torch.clamp((y[0].float() + 1) * 127.5, 0, 255)
    return y.permute(1, 2, 0).cpu().numpy().astype(np.uint8)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("-w", "--fidelity", type=float, default=0.5,
                   help="fidelity/quality weight w in [0, 1]")
    p.add_argument("--ckpt", default="checkpoints/codeformer.pth")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import cv2

    from ..utils.face_restore_helper import FaceRestoreHelper
    from ..utils.media import StreamingVideoWriter, read_video

    device = torch.device(args.device)
    model = build_codeformer(args.ckpt, device)
    helper = FaceRestoreHelper()
    os.makedirs(args.out, exist_ok=True)

    @torch.inference_mode()
    def restore_image(img_rgb):
        restored = []
        for face in helper.align_faces(img_rgb):
            y, _, _ = model(to_model(face.crop, device), w=args.fidelity)
            restored.append((face, to_image(y)))
        return helper.paste_faces(img_rgb, restored)

    if os.path.isdir(args.input):
        inputs = [os.path.join(args.input, f) for f in sorted(os.listdir(args.input))
                  if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    else:
        inputs = [args.input]
    for path in inputs:
        dst = os.path.join(args.out, os.path.basename(path))
        if path.lower().endswith(".mp4"):
            frames = read_video(path, change_fps=False)
            writer = StreamingVideoWriter(dst, 25, frames.shape[1:3])
            try:
                for frame in frames:
                    writer.append(restore_image(frame)[None])
            except BaseException:
                writer.abort()
                raise
            writer.close()
        else:
            img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            cv2.imwrite(dst, cv2.cvtColor(restore_image(img), cv2.COLOR_RGB2BGR))
        print(f"restored {path}")


if __name__ == "__main__":
    main()
