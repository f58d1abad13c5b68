"""Training loggers: MessageLogger-style console lines, TensorBoard
events, and an optional wandb hook.

Counterpart of ``latentsync_tpu/training/loggers.py``, basicsr's logging
stack (ref:basicsr/train.py:55-69, basicsr/utils/logger.py):
`init_tb_logger` → TensorBoardLogger (torch.utils.tensorboard's
SummaryWriter), `init_wandb_logger` → WandbLogger (skipped with a notice
where the wandb package is not installed), and MessageLogger → one JSON
line a record on the console. `build_loggers` reads the basicsr option
keys (logger.use_tb_logger, logger.wandb.project); without them the
console is the only sink.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional


class TensorBoardLogger:
    """Scalar logging to TensorBoard event files
    (ref:basicsr/utils/logger.py init_tb_logger)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=log_dir)

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        for key, value in metrics.items():
            try:
                self.writer.add_scalar(key, float(value), step)
            except (TypeError, ValueError):
                continue
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class WandbLogger:
    """wandb sync hook (ref:basicsr/utils/logger.py init_wandb_logger).
    Without the wandb package the constructor raises ImportError and
    build_loggers skips it with a notice."""

    def __init__(self, project: str, resume_id: Optional[str] = None):
        import wandb  # noqa: F401 — raises if unavailable

        self._wandb = wandb
        kwargs = {"project": project}
        if resume_id:
            kwargs.update(id=resume_id, resume="allow")
        self.run = wandb.init(**kwargs)

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        self._wandb.log(dict(metrics), step=step)

    def close(self) -> None:
        self.run.finish()


class MultiLogger:
    """Fans one (step, metrics) record out to console JSON + sinks."""

    def __init__(self, sinks: List[Callable[[int, Dict[str, Any]], None]],
                 console: Callable[[str], None] = print):
        self.sinks = sinks
        self.console = console

    def __call__(self, step: int, metrics: Dict[str, Any]) -> None:
        self.console(json.dumps({"step": step, **metrics}))
        for sink in self.sinks:
            sink(step, metrics)

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close:
                close()


def build_loggers(opt: Dict[str, Any], output_dir: Optional[str] = None,
                  console: Callable[[str], None] = print) -> MultiLogger:
    """basicsr option keys → MultiLogger (ref:basicsr/train.py:55-69):

    logger:
      use_tb_logger: true        → events under {output_dir}/tb_logger
      wandb: {project: ...}      → wandb run (skipped if not installed)
    """
    log_opt = opt.get("logger", {}) or {}
    sinks: List[Callable[[int, Dict[str, Any]], None]] = []
    if log_opt.get("use_tb_logger") and output_dir:
        sinks.append(TensorBoardLogger(os.path.join(output_dir, "tb_logger")))
    wandb_opt = log_opt.get("wandb") or {}
    if wandb_opt.get("project"):
        try:
            sinks.append(WandbLogger(wandb_opt["project"],
                                     wandb_opt.get("resume_id")))
        except ImportError:
            console("wandb not installed — skipping wandb logging")
    return MultiLogger(sinks, console=console)
