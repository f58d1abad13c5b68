"""Structured stage timers, loss charts, rank-0 logging and profiler traces.

Counterpart of ``latentsync_tpu/utils/observability.py``: ``stage_timer``
records wall times into a shared registry (and an optional sink), and
``timing_summary`` / ``reset_timings`` read and clear it, as there;
``profile_trace`` wraps a block in a ``torch.profiler`` trace (the card's
kernels where there is one) written into the given directory, readable
with TensorBoard or ``chrome://tracing``; ``is_main_process`` is rank 0 of
``torch.distributed`` once it is initialised, else true.

``plot_loss_chart`` writes the same file with the same series and axes as
the JAX package's matplotlib chart (ref:latentsync/utils/util.py:263-276),
drawn with OpenCV instead: matplotlib is not known to be on the GPU
machine, and the SyncNet trainer draws the chart outside any ``try``. The
rendering differs from matplotlib's: a 640x480 white canvas (matplotlib's
default figure at 100 dpi), one polyline a series in matplotlib's default
colours, the extreme values on each axis, "Step" and "Loss", and a
legend.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_TIMINGS: Dict[str, List[float]] = defaultdict(list)

# matplotlib's default colour cycle (tab10), as BGR
_COLOURS = [(180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
            (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23)]


@contextlib.contextmanager
def stage_timer(name: str, sink: Optional[Dict[str, float]] = None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _TIMINGS[name].append(dt)
        if sink is not None:
            sink[name] = dt


def timing_summary() -> Dict[str, Dict[str, float]]:
    return {name: {"count": len(vals), "total_s": sum(vals), "mean_s": sum(vals) / len(vals),
                   "min_s": min(vals)}
            for name, vals in _TIMINGS.items()}


def reset_timings():
    _TIMINGS.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host, and the card's kernels
    where CUDA is available), written into `log_dir` as TensorBoard's
    profiler plugin reads it. Yields `log_dir`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def _ticks(lo: float, hi: float) -> Tuple[float, float]:
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return 0.0, 1.0
    if hi - lo <= 1e-12 * max(1.0, abs(hi)):
        pad = max(abs(hi) * 0.05, 0.5)
        return lo - pad, hi + pad
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def plot_loss_chart(save_path: str, *series: Tuple[str, List, List]) -> None:
    """PNG loss chart: one line per ``(name, steps, losses)`` series against
    "Step" and "Loss", with a legend (ref:latentsync/utils/util.py:263-276)."""
    import cv2
    import numpy as np

    w, h = 640, 480
    left, right, top, bottom = 80, 20, 20, 60
    img = np.full((h, w, 3), 255, np.uint8)
    points = [(float(x), float(y)) for _, xs, ys in series for x, y in zip(xs, ys)
              if math.isfinite(float(x)) and math.isfinite(float(y))]
    x0, x1 = _ticks(min((p[0] for p in points), default=0.0),
                    max((p[0] for p in points), default=1.0))
    y0, y1 = _ticks(min((p[1] for p in points), default=0.0),
                    max((p[1] for p in points), default=1.0))

    def at(x, y):
        px = left + (x - x0) / (x1 - x0) * (w - left - right)
        py = h - bottom - (y - y0) / (y1 - y0) * (h - top - bottom)
        return int(round(px)), int(round(py))

    font, black = cv2.FONT_HERSHEY_SIMPLEX, (0, 0, 0)
    cv2.rectangle(img, (left, top), (w - right, h - bottom), black, 1)
    for x in (x0, x1):
        cv2.putText(img, f"{x:.4g}", (at(x, y0)[0] - 12, h - bottom + 18), font, 0.4, black, 1)
    for y in (y0, y1):
        cv2.putText(img, f"{y:.4g}", (4, at(x0, y)[1] + 4), font, 0.4, black, 1)
    cv2.putText(img, "Step", (w // 2 - 16, h - 14), font, 0.5, black, 1)
    cv2.putText(img, "Loss", (4, h // 2), font, 0.5, black, 1)
    for i, (name, xs, ys) in enumerate(series):
        colour = _COLOURS[i % len(_COLOURS)]
        pts = [at(float(x), float(y)) for x, y in zip(xs, ys)
               if math.isfinite(float(x)) and math.isfinite(float(y))]
        if len(pts) > 1:
            cv2.polylines(img, [np.asarray(pts, np.int32)], False, colour, 2, cv2.LINE_AA)
        elif pts:
            cv2.circle(img, pts[0], 3, colour, -1)
        ly = top + 18 + 18 * i
        cv2.line(img, (w - right - 120, ly - 4), (w - right - 96, ly - 4), colour, 2)
        cv2.putText(img, str(name), (w - right - 90, ly), font, 0.45, black, 1)
    if not cv2.imwrite(save_path, img):
        raise OSError(f"plot_loss_chart: cannot write {save_path}")


def is_main_process() -> bool:
    """Rank 0 of ``torch.distributed`` once it is initialised, else true."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def log_main(message: str) -> None:
    """rank-0-only print (ref:util.py:226-233)."""
    if is_main_process():
        print(f"### {message}")


def write_metrics(path: str, metrics: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(metrics) + "\n")
