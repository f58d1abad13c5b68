"""StableSyncNet accuracy over sampled clips: threshold cos-sim ≥ 0.5 (the
port's counterpart of ``scripts/eval_syncnet_acc.py``;
ref:eval/eval_syncnet_acc.py:13-118).

    python -m latentsync_tpu_torch.scripts.eval_syncnet_acc \\
        --config configs/syncnet_16_pixel_attn.yaml --data-dir CLIPS [--device cpu]

Like the JAX CLI it scores the trainer's freshly initialised weights (the
JAX trainer's ``fast_init`` fill, seed 0) on ``--num-samples`` samples of
``SyncNetSampleSource`` in batches of ``--batch-size``, and prints one JSON
line: ``accuracy``, ``loss`` (the mean of the batches') and ``samples``.
The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="")
    p.add_argument("--fileslist", default="")
    p.add_argument("--data-dir", default="")
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..config import LatentSyncConfig, load_config
    from ..training.data import SyncNetSampleSource
    from ..training.syncnet_trainer import SyncNetTrainer
    from .inference import no_card

    if no_card("eval_syncnet_acc", args.device):
        return 2
    config = load_config(args.config) if args.config else LatentSyncConfig()
    if args.fileslist or args.data_dir:
        config = dataclasses.replace(config, data=dataclasses.replace(
            config.data, train_fileslist=args.fileslist, train_data_dir=args.data_dir))
    trainer = SyncNetTrainer(config, device=args.device)
    source = SyncNetSampleSource(config)
    correct = total = 0
    losses = []
    for _ in range(args.num_samples // args.batch_size):
        samples = [source.sample() for _ in range(args.batch_size)]
        batch = {k: np.stack([s[k] for s in samples]) for k in ("vision", "mel", "y")}
        loss, acc = trainer.eval_step(batch)
        losses.append(loss)
        correct += acc * args.batch_size
        total += args.batch_size
    print(json.dumps({"accuracy": correct / max(total, 1),
                      "loss": sum(losses) / max(len(losses), 1), "samples": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
