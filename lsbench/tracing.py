"""The traced run: ``record_function`` ranges around the program's entry
points, ``torch.profiler`` over the last seconds of the window, and the
reduction of its events.

The profiler is started and stopped on the thread that runs the UNet's
forwards (the batcher's), between two forwards: it records that thread's
operations and ranges, and every kernel on the device whichever thread
launched it. (Profiling every thread, ``profile_all_threads``, aborted a
run with a corrupted heap once in ten; see PERF.md.) A range's device time
is the profiler's own: the device time of the kernels it ties to the
operations launched inside the range. Ranges:

- ``lsbench.entry:<entry>:<precision>:<operations>:<bytes>``: one call of
  a model operation (``counts/entries``), its work in its name;
- ``lsbench.range:<name>[@<weight>]``: a per-layer metric's own range
  (``RANGES`` of a ``metrics/`` reader, or opened by the drive's spies);
  its calls, device time and the sum of their weights are kept by name.

The profiler lists each range a second time as a device-side annotation;
those are no kernels and are left out of the device's busy time. An idle
gap of the device is labelled with the program's stages (prepare, the
denoise, finish) that the host clock saw running at its middle.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from collections import defaultdict

import torch

from .counts import entries

# seconds of the window the profiler records
TRACE_SECONDS = 6.0

# device-kernel families by name (scripts/profile_forward.py's, first match wins)
FAMILIES = [
    ("k8_qmm", ("qmm", "signed char>(ls_gemm")),
    ("k5_cross_core", tuple(f"attn_kernel<{d}, {nwg}, 1," for d in (40, 80) for nwg in (1, 2))),
    ("k2_temporal_block", ("temporal_block",)),
    ("k2_spatial_core", ("k2_spatial_core",)),
    ("gemm_template", ("ls_gemm", "gemm_kernel", "row_stats", "ln_rows", "qkv_kernel")),
    ("k4_spatial_core", ("ls_core", "attn_kernel", "spatial_kernel")),
    ("k3_temporal_core", ("temporal",)),
    ("groupnorm_kernels", ("gn_", "group_norm_silu")),
    ("flash", ("flash",)),
    ("library_convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "nchw", "nhwc")),
    ("library_matmul", ("cutlass", "cublas", "xmma", "gemv", "gemm", "splitk", "int_mm")),
    ("layout_copies_casts", ("copy", "cat", "transpose", "permute", "fill", "index", "gather")),
    ("norms_reductions", ("reduce", "norm", "softmax", "welford", "mean", "var")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


def family_of(name: str) -> str:
    low = name.lower()
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def busy(intervals) -> float:
    """Length of the union of (start, end) intervals
    (scripts/profile_forward.py's ``_busy``)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals):
    """The idle gaps between the union's pieces, [(start, end)]."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


class Tracer:
    def __init__(self, ranges: dict):
        """`ranges`: range name → [``module:attribute``] of the metric readers."""
        self._undo = []
        for name, mod in entries().items():
            for target in mod.TARGETS:
                self._wrap(target, self._entry_wrapper(name, mod.count))
        for name, targets in ranges.items():
            for target in targets:
                self._wrap(target, self._range_wrapper(f"lsbench.range:{name}"))
        self.prof = None
        self.t_start = self.t_stop = None
        self.span = None          # (start, stop) on the host clock, once armed
        self.thread = None        # the traced thread's name
        self.done = threading.Event()
        self._lock = threading.Lock()

    def _wrap(self, target: str, make):
        module, attr = _resolve(target)
        orig = getattr(module, attr)
        setattr(module, attr, make(orig))
        self._undo.append(lambda: setattr(module, attr, orig))

    @staticmethod
    def _entry_wrapper(name, count):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                ops, moved, prec = count(*a, **k)
                with torch.profiler.record_function(
                        f"lsbench.entry:{name}:{prec}:{int(ops)}:{int(moved)}"):
                    return fn(*a, **k)
            return wrapper
        return make

    @staticmethod
    def _range_wrapper(label):
        def make(fn):
            @functools.wraps(fn)
            def wrapper(*a, **k):
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            return wrapper
        return make

    @staticmethod
    def _profile(**kw):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts, **kw)

    def prepare(self) -> None:
        """Set-up of a traced run: the profiler's first start in a process
        initialises its device tracing (seconds), so it happens here, not
        in the window."""
        with self._profile():
            if torch.cuda.is_available():
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def arm(self, start: float, stop: float) -> None:
        """Trace from the first UNet forward at or after `start` (host
        clock) to the first at or after `stop`; `done` is set then."""
        self.span = (start, stop)

    def at_forward(self) -> None:
        """Called on the denoise's thread before each UNet forward."""
        if self.span is None or self.done.is_set():
            return
        now = time.perf_counter()
        with self._lock:
            if self.prof is None and now >= self.span[0]:
                self.thread = threading.current_thread().name
                self.prof = self._profile()
                self.prof.__enter__()
                self.t_start = time.perf_counter()
                with torch.profiler.record_function("lsbench.mark"):
                    self.t_mark = time.perf_counter()
            elif (self.prof is not None and now >= self.span[1]
                  and threading.current_thread().name == self.thread):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.t_stop = time.perf_counter()
                self.prof.__exit__(None, None, None)
                self.done.set()

    def undo(self) -> None:
        for fn in reversed(self._undo):
            fn()

    def summary(self, stages=()) -> dict:
        """Reduce the trace: device busy time and window, kernel time by
        family, each range's device time, the entries' (operations, bytes,
        device time), and the longest idle gaps labelled by the `stages`
        ((name, host start, host end)) running at their middle."""
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        events = self.prof.events()
        families = defaultdict(float)
        ranges = defaultdict(lambda: [0, 0.0, 0.0])
        entry_rows, kernels, by_name = [], [], defaultdict(float)
        offset = None
        for e in events:
            name = e.name
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or name.startswith("lsbench."):
                    continue
                s, t = e.time_range.start, e.time_range.end
                kernels.append((s, t))
                families[family_of(name)] += (t - s) / 1e6
                by_name[name] += (t - s) / 1e6
                continue
            if not name.startswith("lsbench."):
                continue
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = e.cuda_time_total
            if name == "lsbench.mark":
                offset = self.t_mark - e.time_range.start / 1e6
            elif name.startswith("lsbench.entry:"):
                _, entry, prec, n_ops, moved = name.split(":")
                entry_rows.append((entry, prec, int(n_ops), int(moved), dev / 1e6))
            elif name.startswith("lsbench.range:"):
                label, _, weight = name.split(":", 1)[1].partition("@")
                r = ranges[label]
                r[0] += 1
                r[1] += dev / 1e6
                r[2] += float(weight or 0)
        out = {"window_s": self.t_stop - self.t_start, "thread": self.thread,
               "families": dict(families), "ranges": {k: tuple(v) for k, v in ranges.items()},
               "entries": entry_rows, "kernels": len(kernels),
               "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
        if kernels:
            out["busy_s"] = busy(kernels) / 1e6
            labelled = []
            for g0, g1 in gaps(kernels):
                label = "unknown"
                if offset is not None:
                    mid = offset + (g0 + g1) / 2e6
                    label = "+".join(sorted({n for n, a, b in stages if a <= mid <= b})) \
                        or "no stage"
                labelled.append((g1 - g0, label))
            labelled.sort(reverse=True)
            out["idle_gaps"] = [[label, dur / 1e6] for dur, label in labelled[:10]]
        out["reduce_s"] = time.perf_counter() - t0
        return out
