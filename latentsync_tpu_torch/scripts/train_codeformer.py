"""CodeFormer / VQGAN staged training on one card (the port's counterpart of
``scripts/train_codeformer.py``, ref:basicsr/train.py + options/*.yml).

    python -m latentsync_tpu_torch.scripts.train_codeformer --stage vqgan|code|joint \\
        --data-dir FACES [--max-steps 1000] [--batch-size 4] [--output-dir DIR] [--device cpu]

Trains over a directory of face images (or a basicsr ``*.lmdb``) degraded
on the host by ``training/degradations.FFHQBlindSource`` (seeded by
``--seed``): ``vqgan`` the full-width ``VQAutoEncoder`` against a
``VQGANDiscriminator``, ``code`` the full-width ``CodeFormer``'s code
prediction (stage II), ``joint`` CodeFormer with its fuse blocks against
the discriminator (stage III). As the JAX CLI: bf16 compute on f32 master
weights, Adam at ``--lr`` with betas (0.5, 0.9), seeded random weights,
one JSON line of the step's metrics every LOG_EVERY steps, the
generator's weights saved as
``step_%08d.pt`` under ``--output-dir`` at the end. The card unless
``--device cpu``. ``main`` also returns the metrics and the seconds of
each step (the host's clock around the step, which ends in reading the
metrics back).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

LOG_EVERY = 10


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage", choices=["vqgan", "code", "joint"], required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--output-dir", default="debug/codeformer")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..models import codeformer as cf
    from ..training.degradations import FFHQBlindSource
    from ..training.restoration_trainer import CodeFormerStageII, CodeFormerStageIII, VQGANTrainer
    from ..utils.checkpoint import save_checkpoint
    from ..utils.convert import init_random_
    from .inference import no_card

    if no_card("train_codeformer", args.device):
        return None
    device = torch.device(args.device)
    dtype = torch.bfloat16
    source = FFHQBlindSource(args.data_dir, seed=args.seed)
    with torch.no_grad():
        if args.stage == "vqgan":
            model = init_random_(cf.VQAutoEncoder(img_size=args.img_size), args.seed)
        else:
            model = init_random_(cf.CodeFormer(img_size=args.img_size), args.seed)
        disc = init_random_(cf.VQGANDiscriminator(), args.seed + 1)
    model.to(device)

    def adam(leaves):
        return torch.optim.Adam(list(leaves), lr=args.lr, betas=(0.5, 0.9), eps=1e-8)

    if args.stage == "code":
        trainer = CodeFormerStageII(model, dtype=dtype)
        step_fn = trainer.make_step(adam(trainer.g.leaves.values()))
    else:
        disc.to(device)
        if args.stage == "vqgan":
            trainer = VQGANTrainer(model, disc, dtype=dtype)
            make = trainer.make_steps
        else:
            trainer = CodeFormerStageIII(model, disc, dtype=dtype)
            make = trainer.make_step
        step_fn = make(adam(trainer.g.leaves.values()), adam(trainer.d.leaves.values()))

    history, seconds = [], []
    for step in range(1, args.max_steps + 1):
        samples = [source.sample() for _ in range(args.batch_size)]
        batch = {k: np.stack([s[k] for s in samples]) for k in ("lq", "gt")}
        t0 = time.perf_counter()
        metrics = step_fn(batch)
        seconds.append(time.perf_counter() - t0)
        history.append(metrics)
        if step % LOG_EVERY == 0:
            print(json.dumps({"step": step, **metrics}), flush=True)
    save_checkpoint(args.output_dir, args.max_steps, trainer.g.state_dict())
    return {"metrics": history, "step_seconds": seconds}


if __name__ == "__main__":
    main()
