"""Lip-sync a list of (video, audio) pairs, optionally scoring each output
(the port's counterpart of ``scripts/inference_videos.py``;
ref:eval/inference_videos.py).

    python -m latentsync_tpu_torch.scripts.inference_videos --pairs pairs.tsv \\
        --out-dir OUT [--score] [--unet-config ...] [--unet-ckpt ...] [--device cpu]

``--pairs``: lines ``video_path<TAB>audio_path``. One pipeline
(``scripts/inference.build_pipeline``) renders every pair into
``--out-dir`` under the video's name and prints one JSON line a pair
(``video``, ``out``, ``frames``, and with ``--score`` the SyncNet scorer's
``av_offset`` and ``confidence``: seeded random weights, as in the JAX
CLI). The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from .inference import add_model_args, build_pipeline, no_card

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", required=True, help="lines: video_path<TAB>audio_path")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--score", action="store_true")
    add_model_args(p)
    args = p.parse_args(argv)
    if no_card("inference_videos", args.device):
        return 2

    pipe = build_pipeline(args)
    os.makedirs(args.out_dir, exist_ok=True)
    evaluator = None
    if args.score:
        from ..eval.sync_eval import SyncNetEvaluator

        evaluator = SyncNetEvaluator(device=args.device)
    with open(args.pairs) as f:
        pairs = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    for video, audio in pairs:
        out = os.path.join(args.out_dir, os.path.basename(video))
        r = pipe(video_path=video, audio_path=audio, video_out_path=out)
        row = {"video": video, "out": r.video_path, "frames": r.num_frames}
        if evaluator is not None:
            offset, _, conf = evaluator.evaluate(r.video_path)
            row.update(av_offset=offset, confidence=round(conf, 4))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
