"""Sync confidence of lip-synced videos (the port's counterpart of
``scripts/eval_sync_conf.py``; ref:eval/eval_sync_conf.py, eval_sync_conf.sh).

    python -m latentsync_tpu_torch.scripts.eval_sync_conf --video out.mp4 [--dir videos/] \\
        [--syncnet-ckpt checkpoints/auxiliary/syncnet_v2.model] [--device cpu]

Scores each video (``--video``, and every ``.mp4`` of ``--dir``) with the
SyncNet scorer and prints one JSON line a video (``video``, ``av_offset``,
``min_dist``, ``confidence``), then, for more than one, the mean
confidence. Without the scorer's file the weights are seeded random ones
and the numbers mean nothing. The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video", default="")
    p.add_argument("--dir", default="")
    p.add_argument("--syncnet-ckpt", default="checkpoints/auxiliary/syncnet_v2.model")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..eval.sync_eval import evaluator_from_file
    from .inference import no_card

    if no_card("eval_sync_conf", args.device):
        return 2
    evaluator, _ = evaluator_from_file(args.syncnet_ckpt, args.device)
    videos = [args.video] if args.video else []
    if args.dir:
        videos += [os.path.join(args.dir, f) for f in sorted(os.listdir(args.dir))
                   if f.endswith(".mp4")]
    confs = []
    for v in videos:
        offset, min_dist, conf = evaluator.evaluate(v)
        confs.append(conf)
        print(json.dumps({"video": v, "av_offset": offset, "min_dist": round(min_dist, 4),
                          "confidence": round(conf, 4)}), flush=True)
    if len(confs) > 1:
        print(json.dumps({"mean_confidence": sum(confs) / len(confs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
