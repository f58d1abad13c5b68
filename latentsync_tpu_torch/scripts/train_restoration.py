"""Option-file-driven restoration training on one card (the port's
counterpart of ``scripts/train_restoration.py``, ref:basicsr/train.py).

    python -m latentsync_tpu_torch.scripts.train_restoration -opt options/vqgan_stage1.yaml \\
        [--max-steps N] [--img-size 512] [--output-dir DIR] [--log-every 10] [--seed S] \\
        [--device cpu]

The option file selects model_type (VQGANModel / CodeFormerIdxModel /
CodeFormerJointModel), networks, optimizer, LR schedule, EMA decay and the
FFHQ blind-degradation dataset (its ``dataroot_gt``: a directory of face
images or a basicsr ``*.lmdb``), run by the registry-driven
``training/option_trainer.OptionTrainer``. ``--seed`` replaces the options'
``manual_seed``. The card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-opt", "--options", required=True)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..training.option_trainer import OptionTrainer, parse_options
    from .inference import no_card

    if no_card("train_restoration", args.device):
        return None
    opt = dict(parse_options(args.options))
    if args.seed is not None:
        opt["manual_seed"] = args.seed
    trainer = OptionTrainer(opt, device=args.device)
    return trainer.run(max_steps=args.max_steps, img_size=args.img_size,
                       output_dir=args.output_dir, log_every=args.log_every)


if __name__ == "__main__":
    main()
