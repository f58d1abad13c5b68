"""Option-file-driven restoration trainer (basicsr train.py parity).

Counterpart of ``latentsync_tpu/training/option_trainer.py``
(ref:basicsr/train.py:24-280 + ref:options/*.yml): a YAML file or dict of
options selects the dataset, the generator and discriminator, optimizer,
LR schedule, EMA decay and trainer stage from the registries
(``training/registry.py``), then runs the step loop with JSON-line
logging and saves a checkpoint.

As in the JAX package, and kept: ``_filter_kwargs`` drops every option key
the architecture does not take (the degradation keys, ``fidelity_weight``,
``fix_modules`` …), so the same option file builds the same network in
both packages (the port's constructors take the JAX modules' field names);
the discriminator's optimizer follows the generator's schedule (built from
``optim_g``'s lr) where there is one; the EMA starts at the initial
generator weights, updates after every step, and is what the checkpoint
holds when ``ema_decay`` is set. The networks are built with seeded random
weights (``utils/convert.init_random_``, from ``manual_seed``), which a
caller may replace (``net_g.load_state_dict``) before ``run``. The loop
runs on the card unless the trainer is built with another ``device``.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .registry import (ARCH_REGISTRY, DATASET_REGISTRY, METRIC_REGISTRY, SCHEDULER_REGISTRY,
                       register_builtin)
from .restoration_trainer import CodeFormerStageII, CodeFormerStageIII, VQGANTrainer, ema_update

# basicsr model_type → trainer stage (ref:options/*.yml model_type)
_MODEL_TYPES = {
    "VQGANModel": "vqgan",
    "CodeFormerIdxModel": "code",
    "CodeFormerJointModel": "joint",
}


def parse_options(path_or_dict) -> Dict[str, Any]:
    """YAML path or dict → options dict (ref:basicsr/utils/options.py)."""
    if isinstance(path_or_dict, dict):
        return path_or_dict
    import yaml

    with open(path_or_dict) as f:
        return yaml.safe_load(f)


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the keyword arguments the architecture takes, lists as
    tuples: option files carry bookkeeping keys (fix_modules, vqgan_path, …)
    that basicsr also strips."""
    names = set(inspect.signature(cls).parameters)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items() if k in names}


def scheduled(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
    """Give `optimizer` an optax-style schedule: its n-th update (from 0)
    runs at lr = schedule(n)."""
    count = [0]

    def set_lr(opt, args, kwargs):
        lr = schedule(count[0])
        count[0] += 1
        for group in opt.param_groups:
            group["lr"] = lr

    optimizer.register_step_pre_hook(set_lr)
    return optimizer


def build_optimizer(opt: Dict[str, Any], params: Iterable[torch.Tensor], schedule=None):
    """The optax optimizer the JAX package builds from the same options:
    Adam (optax's eps 1e-8), AdamW where there is a weight decay (decoupled,
    as optax.adamw), SGD with momentum."""
    kind = opt.get("type", "Adam").lower()
    lr = opt.get("lr", 1e-4)
    betas = tuple(opt.get("betas", [0.9, 0.999]))
    wd = opt.get("weight_decay", 0.0)
    params = list(params)
    if kind == "adam" and not wd:
        out = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    elif kind in ("adam", "adamw"):
        out = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    elif kind == "sgd":
        out = torch.optim.SGD(params, lr=lr, momentum=opt.get("momentum", 0.0))
    else:
        raise ValueError(f"unknown optimizer type {opt.get('type')}")
    return scheduled(out, schedule) if schedule is not None else out


def build_schedule(opt: Optional[Dict[str, Any]], base_lr: float):
    if not opt:
        return None
    kind = opt["type"]
    if kind in ("MultiStepLR", "MultiStepRestartLR"):
        fn = SCHEDULER_REGISTRY.get("MultiStepRestartLR")
        return fn(base_lr, milestones=opt.get("milestones", []), gamma=opt.get("gamma", 0.1),
                  restarts=opt.get("restarts", (0,)),
                  restart_weights=opt.get("restart_weights", (1.0,)))
    if kind == "CosineAnnealingRestartLR":
        fn = SCHEDULER_REGISTRY.get("CosineAnnealingRestartLR")
        return fn(base_lr, periods=opt["periods"], restart_weights=opt.get("restart_weights"),
                  eta_min=opt.get("eta_min", 1e-7))
    raise ValueError(f"unknown scheduler type {kind}")


class OptionTrainer:
    """Generic registry-driven trainer: ``OptionTrainer(opt).run()``."""

    def __init__(self, opt: Dict[str, Any], data_source=None,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        register_builtin()
        self.opt = opt
        self.log = log_fn
        self.device = torch.device(device)
        self.stage = _MODEL_TYPES.get(opt.get("model_type"))
        if self.stage is None:
            raise ValueError(f"unsupported model_type {opt.get('model_type')}")

        self.dtype = torch.bfloat16 if opt.get("bf16", True) else torch.float32
        g_opt = dict(opt["network_g"])
        g_cls = ARCH_REGISTRY.get(g_opt.pop("type"))
        self.net_g = g_cls(**_filter_kwargs(g_cls, g_opt))

        d_opt = dict(opt.get("network_d", {"type": "VQGANDiscriminator"}))
        d_cls = ARCH_REGISTRY.get(d_opt.pop("type"))
        self.net_d = d_cls(**_filter_kwargs(d_cls, d_opt))
        self._init_params(int(opt.get("manual_seed", 0)))

        train = opt.get("train", {})
        self.optim_g = train.get("optim_g", {})
        self.optim_d = train.get("optim_d", self.optim_g)
        self.schedule = build_schedule(train.get("scheduler"), self.optim_g.get("lr", 1e-4))
        self.ema_decay = train.get("ema_decay", 0.0)
        self.total_iter = int(train.get("total_iter", 1000))

        if data_source is not None:
            self.source = data_source
        else:
            ds_opt = dict(opt["datasets"]["train"])
            ds_cls = DATASET_REGISTRY.get(ds_opt.pop("type"))
            self.source = ds_cls(ds_opt.pop("dataroot_gt"))
        self.batch_size = opt.get("datasets", {}).get("train", {}).get("batch_size_per_gpu", 4)

    # ------------------------------------------------------------------

    def _init_params(self, seed: int) -> None:
        from ..utils.convert import init_random_

        with torch.no_grad():
            init_random_(self.net_g, seed)
            init_random_(self.net_d, seed + 1)

    def run(self, max_steps: Optional[int] = None, img_size: int = 512,
            output_dir: Optional[str] = None, log_every: int = 10,
            batch_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None):
        """Train for min(total_iter, max_steps) steps from the networks' present
        weights. `batch_fn(step)` gives the batch in place of the data source.
        `img_size` is the JAX signature's (its initialisation traces an image;
        the port's modules are built by the options alone). Returns the final
        generator, discriminator and EMA state dicts and the last metrics."""
        from ..utils.checkpoint import save_checkpoint
        from .loggers import build_loggers

        logger = build_loggers(self.opt, output_dir, console=self.log)
        steps = min(self.total_iter, max_steps or self.total_iter)
        self.net_g.to(self.device)
        self.net_d.to(self.device)

        if self.stage == "vqgan":
            trainer = VQGANTrainer(self.net_g, self.net_d, dtype=self.dtype)
        elif self.stage == "code":
            trainer = CodeFormerStageII(self.net_g, dtype=self.dtype)
        else:
            trainer = CodeFormerStageIII(self.net_g, self.net_d, dtype=self.dtype)
        g_opt = build_optimizer(self.optim_g, trainer.g.leaves.values(), self.schedule)
        if self.stage == "code":
            step_fn = trainer.make_step(g_opt)
            d_leaves = {k: v.detach() for k, v in self.net_d.state_dict().items()}
        else:
            d_opt = build_optimizer(self.optim_d, trainer.d.leaves.values(), self.schedule)
            step_fn = trainer.make_steps(g_opt, d_opt) if self.stage == "vqgan" \
                else trainer.make_step(g_opt, d_opt)
        ema = {k: v.detach().clone() for k, v in trainer.g.leaves.items()} \
            if self.ema_decay else None

        metrics: Dict[str, float] = {}
        t0 = time.time()
        try:
            for step in range(1, steps + 1):
                if batch_fn is not None:
                    batch = batch_fn(step)
                else:
                    samples = [self.source.sample() for _ in range(self.batch_size)]
                    batch = {k: np.stack([s[k] for s in samples]) for k in ("lq", "gt")}
                metrics = step_fn(batch)
                if ema is not None:
                    ema_update(ema, trainer.g.leaves, self.ema_decay)
                if step % log_every == 0 or step == steps:
                    logger(step, {"iters_per_sec": round(step / (time.time() - t0), 3),
                                  **metrics})
        finally:
            # a crash (OOM, a NaN) must not leave a TensorBoard / wandb writer
            # with its last events unflushed
            logger.close()
        g_params = trainer.g.state_dict()
        if output_dir:
            save_checkpoint(output_dir, steps, ema if ema is not None else g_params)
        return {"g_params": g_params,
                "d_params": d_leaves if self.stage == "code" else trainer.d.state_dict(),
                "ema_params": ema, "metrics": metrics}


def validate(params: Optional[Dict[str, torch.Tensor]], net: torch.nn.Module, pairs,
             metrics=("psnr", "ssim")) -> Dict[str, float]:
    """basicsr-style metric validation over (lq, gt) pairs of (H, W, 3)
    images: `net` (with the state dict `params` in place of its own where
    given) on each lq, its first output against gt."""
    register_builtin()
    fns = {m: METRIC_REGISTRY.get(m) for m in metrics}
    acc = {m: [] for m in metrics}
    dev = next(net.parameters()).device
    for lq, gt in pairs:
        x = torch.as_tensor(np.asarray(lq, np.float32)).permute(2, 0, 1)[None].to(dev)
        with torch.no_grad():
            pred = net(x) if params is None else torch.func.functional_call(net, params, (x,))
        pred = pred[0] if isinstance(pred, tuple) else pred
        pred_img = pred[0].float().permute(1, 2, 0).cpu().numpy()
        for m, fn in fns.items():
            acc[m].append(float(fn(pred_img, np.asarray(gt, np.float32))))
    return {m: float(np.mean(acc[m])) if acc[m] else float("nan") for m in metrics}
