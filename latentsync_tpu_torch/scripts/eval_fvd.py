"""Fréchet video distance between two directories of clips (the port's
counterpart of ``scripts/eval_fvd.py``; ref:eval/eval_fvd.py:26, fvd.py:28).

    python -m latentsync_tpu_torch.scripts.eval_fvd --real-dir REAL --fake-dir FAKE \\
        [--num-frames 16] [--size 224] [--device cpu]

Each ``.mp4`` of at least ``--num-frames`` frames gives its first
``--num-frames`` frames, resized to ``--size``², in [-1, 1], to the
Kinetics-400 I3D (``models/i3d.py``, f32 with TF32 off on the card,
``FVD_BATCH`` clips a forward); the pre-softmax logits of the two sets
give the FVD. ``$LATENTSYNC_I3D_CKPT`` names the I3D weights: a ``.pt`` /
``.pth`` in piergiaj's layout (the
port's own saved state dict is one), or an ``.npz`` of the port's names or
of the JAX package's tree. Without one the weights are seeded random ones:
a warning goes to stderr and the JSON line (``fvd``, ``n_real``,
``n_fake``, ``i3d_weights``) says ``"i3d_weights": "random"``; such an FVD
compares only within one run. The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# clips a forward: the FVD point's batch (rows are independent in inference mode)
FVD_BATCH = 4


def load_i3d(ckpt: str, device):
    """(InceptionI3D on `device`, "pretrained" or "random")."""
    import torch

    from ..models.face_detection import _load
    from ..models.i3d import InceptionI3D
    from ..utils.convert import i3d_state_dict_from_flax, init_random_bn_, load_state_dict_file

    model = InceptionI3D()
    if os.path.isfile(ckpt):
        sd = load_state_dict_file(ckpt, i3d_state_dict_from_flax)
        _load(model, {("logits." + k[7:] if k.startswith("Logits.") else k): v
                      for k, v in sd.items()})
        source = "pretrained"
    else:
        print(f"WARNING: no I3D checkpoint at {ckpt!r}: using RANDOM weights. The FVD below "
              "is only a within-run relative number and is NOT comparable to "
              "Kinetics-pretrained FVD scores (set $LATENTSYNC_I3D_CKPT to a checkpoint).",
              file=sys.stderr)
        init_random_bn_(model, seed=0)
        source = "random"
    return model.to(torch.device(device)).eval(), source


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--real-dir", required=True)
    p.add_argument("--fake-dir", required=True)
    p.add_argument("--num-frames", type=int, default=16)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from .inference import no_card

    if no_card("eval_fvd", args.device):
        return 2
    import cv2
    import numpy as np
    import torch

    from ..models.face_detection import no_tf32
    from ..models.perceptual import compute_fvd
    from ..utils.media import read_video

    device = torch.device(args.device)
    model, source = load_i3d(os.environ.get("LATENTSYNC_I3D_CKPT", "checkpoints/i3d.npz"),
                             device)

    def clips_of(directory):
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".mp4"):
                continue
            frames = read_video(os.path.join(directory, name), change_fps=False)
            if len(frames) < args.num_frames:
                continue
            clip = np.stack([cv2.resize(f, (args.size, args.size))
                             for f in frames[:args.num_frames]])
            yield clip.astype(np.float32) / 127.5 - 1.0

    @torch.inference_mode()
    def features_for(directory):
        clips, feats = list(clips_of(directory)), []
        with no_tf32(device):
            for i in range(0, len(clips), FVD_BATCH):
                x = torch.from_numpy(np.stack(clips[i:i + FVD_BATCH])).to(device)
                feats.append(model(x.permute(0, 4, 1, 2, 3)))
        return torch.cat(feats)

    real, fake = features_for(args.real_dir), features_for(args.fake_dir)
    print(json.dumps({"fvd": compute_fvd(fake, real), "n_real": len(real),
                      "n_fake": len(fake), "i3d_weights": source}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
