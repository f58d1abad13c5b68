"""SyncNet training, on one card or data-parallel across several (the port's
counterpart of ``scripts/train_syncnet.py``; ref:scripts/train_syncnet.py:39-262).

    python -m latentsync_tpu_torch.scripts.train_syncnet \\
        --config configs/syncnet_16_pixel_attn.yaml --max-steps 4 [--device cpu]
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m latentsync_tpu_torch.scripts.train_syncnet --config ...

Trains ``training/syncnet_trainer.SyncNetTrainer`` (bf16 compute on f32
master weights, seeded as the JAX trainer's ``fast_init``) on the clips the
config's ``data.train_fileslist`` / ``train_data_dir`` name (``.mp4`` with a
``.wav`` sidecar where there is no ffmpeg), printing one JSON line every
``--log-every`` steps (``step``, ``loss``, ``sat_frac``, ``steps_per_sec``).
Every ``--validation-steps`` steps it scores the validation source (the
config's ``data.val_fileslist``) or, without one, the current batch,
redraws ``loss_chart.png`` and saves ``step_%08d.pt`` with the train and
val loss histories; it saves once more at the end. ``--resume`` continues
from the latest checkpoint in ``--output-dir``: weights, optimizer state,
histories and step. The card unless ``--device cpu``. Under
``torch.distributed.run`` the first ``gcd(batch, ranks)`` ranks train
(``parallel/mesh.py``); a rank beyond them says so and exits 0; rank 0
alone prints, charts and saves.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="")
    p.add_argument("--max-steps", type=int, default=0)
    p.add_argument("--output-dir", default="debug/syncnet")
    p.add_argument("--validation-steps", type=int, default=2500)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --output-dir (weights, optimizer "
                        "state, loss histories and step) and continue")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..config import LatentSyncConfig, load_config
    from ..parallel.mesh import card_of_rank, init_data_parallel, shutdown
    from .inference import no_card

    if no_card("train_syncnet", args.device):
        return 2
    device = card_of_rank(args.device)
    config = load_config(args.config) if args.config else LatentSyncConfig()
    batch_size = max(config.data.batch_size, 1)
    place = init_data_parallel(batch_size, device)
    if not place.active:
        print(f"train_syncnet: rank {place.rank} of {place.world} idle: the data-parallel "
              f"degree is gcd(batch {batch_size}, {place.world} ranks) = {place.dp}")
        return 0
    try:
        return _train(args, config, place, device)
    finally:
        shutdown()


def _train(args, config, place, device) -> int:
    from ..parallel.mesh import broadcast_
    from ..training.data import HostDataLoader, SyncNetSampleSource, load_fileslist
    from ..training.syncnet_trainer import SyncNetTrainer
    from ..utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from ..utils.observability import plot_loss_chart

    main = place.rank == 0
    if main:
        os.makedirs(args.output_dir, exist_ok=True)
        if place.distributed:
            print(json.dumps({"data_parallel": {"backend": torch.distributed.get_backend(),
                                                "world": place.world, "dp": place.dp}}))
    trainer = SyncNetTrainer(config, device=device)
    local = max(config.data.batch_size, 1) // place.dp
    loader = HostDataLoader(SyncNetSampleSource(config, seed=config.run.seed), batch_size=local,
                            host_id=place.rank, num_hosts=place.dp)
    # held-out validation source (ref:train_syncnet.py:238-252); the current
    # train batch where the config names none
    val_source = None
    if config.data.val_fileslist:
        val_paths = load_fileslist(config.data.val_fileslist, config.data.train_data_dir)
        if val_paths:
            val_source = SyncNetSampleSource(config, video_paths=val_paths,
                                             seed=config.run.seed + 1 + place.rank)

    max_steps = args.max_steps or config.run.max_train_steps
    train_hist, val_hist = [], []
    step = 0
    if args.resume:
        ckpt = latest_checkpoint(args.output_dir)
        if ckpt:
            state = restore_checkpoint(ckpt)
            trainer.model.load_state_dict(state["params"])
            trainer.optimizer.load_state_dict(state["opt_state"])
            aux = state.get("aux", {})
            train_hist = [tuple(r) for r in aux.get("train_hist", [])]
            val_hist = [tuple(r) for r in aux.get("val_hist", [])]
            step = int(state["step"])
            if main:
                print(json.dumps({"resumed_from": ckpt, "step": step}))
    broadcast_(list(trainer.params.values()))

    saved = {}

    def save():
        if saved.get("step") != step:  # a validation step's checkpoint is this one
            saved.update(step=step, path=save_checkpoint(
                args.output_dir, step, trainer.params, trainer.optimizer.state_dict(),
                aux={"train_hist": train_hist, "val_hist": val_hist}))
        return saved["path"]

    t0 = time.time()
    try:
        for batch in loader:
            metrics = trainer.train_step(batch)
            step += 1
            if step % args.log_every == 0:
                train_hist.append((step, metrics["loss"]))
                if main:
                    print(json.dumps({"step": step, "loss": metrics["loss"],
                                      "sat_frac": metrics["sat_frac"],
                                      "steps_per_sec": args.log_every / (time.time() - t0)}),
                          flush=True)
                t0 = time.time()
            if step % args.validation_steps == 0:
                if val_source is not None:
                    samples = [val_source.sample() for _ in range(local)]
                    vbatch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
                else:
                    vbatch = batch
                vloss, vacc = trainer.eval_step(vbatch)
                val_hist.append((step, vloss))
                if main:
                    print(json.dumps({"val_step": step, "val_loss": vloss, "val_acc": vacc}),
                          flush=True)
                    plot_loss_chart(
                        os.path.join(args.output_dir, "loss_chart.png"),
                        ("train", [s for s, _ in train_hist], [v for _, v in train_hist]),
                        ("val", [s for s, _ in val_hist], [v for _, v in val_hist]))
                    save()
            if step >= max_steps:
                break
    finally:
        loader.close()
    if main:
        print(json.dumps({"saved": save(), "step": step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
