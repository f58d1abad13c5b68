"""VQGAN latent-GT code maps for CodeFormer's stage-II training (the port's
counterpart of ``scripts/generate_latent_gt.py``).

    python -m latentsync_tpu_torch.scripts.generate_latent_gt -i FACES -o OUT \\
        [--codebook_size 1024] [--ckpt_path vqgan.pth] [--device cpu]

Each ``*.png`` / ``*.jpg`` of the input directory, resized to the model's
512², and its horizontal flip go through the full-width ``VQAutoEncoder``
in f32, as the JAX script runs it; the 16 × 16 code indices are saved in
``latent_gt_code<codebook_size>.npz`` under the keys ``orig/<name>`` and
``hflip/<name>`` (the torch reference pickles a nested dict).
``--ckpt_path`` is a ``.pth`` in basicsr's layout (wrappers unwrapped), or
an ``.npz`` of the JAX package's parameter tree, carried over by
``utils/convert.codeformer_state_dict_from_flax`` (the inverse of the JAX
package's ``convert_codeformer``); without one the weights are seeded
random (``--seed``), with a warning. The card unless ``--device cpu`` (on
the card f32 convolutions go through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is turned off).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--test_path", "-i", required=True)
    p.add_argument("--save_root", "-o", required=True)
    p.add_argument("--codebook_size", type=int, default=1024)
    p.add_argument("--ckpt_path", default=None,
                   help="VQGAN weights (.pth, or a JAX .npz tree); random weights if omitted")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    import cv2

    from ..models import codeformer as cf
    from ..utils.convert import (codeformer_state_dict_from_flax, init_random_,
                                 load_state_dict_file)
    from .inference import no_card

    if no_card("generate_latent_gt", args.device):
        return None
    device = torch.device(args.device)
    model = cf.VQAutoEncoder(codebook_size=args.codebook_size)
    if args.ckpt_path and os.path.isfile(args.ckpt_path):
        model.load_state_dict(load_state_dict_file(args.ckpt_path,
                                                   codeformer_state_dict_from_flax))
    else:
        print("WARNING: no checkpoint — latent codes use RANDOM weights")
        with torch.no_grad():
            init_random_(model, args.seed)
    model = model.eval().to(device)

    os.makedirs(args.save_root, exist_ok=True)
    out = {}
    paths = sorted(glob.glob(os.path.join(args.test_path, "*.[jp][pn]g")))
    size_latent = 16
    for flip in ("orig", "hflip"):
        for path in paths:
            name = os.path.splitext(os.path.basename(path))[0]
            img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (model.img_size, model.img_size))
            if flip == "hflip":
                img = img[:, ::-1]
            x = torch.from_numpy(img.astype(np.float32) / 255.0 * 2.0 - 1.0)  # (0.5, 0.5) norm
            with torch.inference_mode():
                _, _, idx = model(x.permute(2, 0, 1)[None].to(device))
            out[f"{flip}/{name}"] = idx.cpu().numpy().reshape(size_latent, size_latent)
            print(name, flip, out[f"{flip}/{name}"].shape)

    save_path = os.path.join(args.save_root, f"latent_gt_code{args.codebook_size}.npz")
    np.savez(save_path, **out)
    print(f"Latent GT codes saved to {save_path}")
    return save_path


if __name__ == "__main__":
    main()
