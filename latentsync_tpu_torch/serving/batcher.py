"""Continuous window batching for multi-clip serving.

Counterpart of ``latentsync_tpu/serving/batcher.py``. The unit of
scheduling is a 16-frame window, not a clip: each job submits one item a
window (its tensors, already on the pipeline's device), and one scheduler
thread drains up to ``max_windows`` items, stacks them into one denoise
batch (a short batch is padded by repeating its last item) and hands each
item its row of the result through a future. Windows are independent, so
a batch may hold windows of several jobs. A failure of the batch function
reaches every future of its batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


@dataclass
class WindowItem:
    inputs: Dict[str, torch.Tensor]  # one window's tensors, the same shapes in every item
    future: Future = field(default_factory=Future)


class WindowBatcher:
    """`batch_fn(stacked: Dict[str, Tensor]) -> Tensor` with a leading
    window axis of `max_windows`."""

    def __init__(self, batch_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                 max_windows: int = 2, max_wait_ms: float = 5.0):
        self.batch_fn = batch_fn
        self.max_windows = max_windows
        self.max_wait = max_wait_ms / 1000.0
        self.queue: "queue.Queue[WindowItem]" = queue.Queue()
        self.thread = threading.Thread(target=self._loop, name="window-batcher", daemon=True)
        self.thread.start()

    def submit(self, inputs: Dict[str, torch.Tensor]) -> Future:
        item = WindowItem(inputs)
        self.queue.put(item)
        return item.future

    def submit_clip(self, per_window_inputs: List[Dict[str, torch.Tensor]]) -> List[Future]:
        return [self.submit(w) for w in per_window_inputs]

    def _collect(self) -> List[WindowItem]:
        """The first waiting item, and what else arrives within max_wait
        of it, up to max_windows items (None: the batcher is closing)."""
        first = self.queue.get()
        if first is None:
            return []
        items = [first]
        t0 = time.monotonic()
        while len(items) < self.max_windows:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                self.queue.put(None)  # let the loop see it after this batch
                break
            items.append(item)
        return items

    def _loop(self):
        while True:
            items = self._collect()
            if not items:
                return
            pad = self.max_windows - len(items)
            try:
                stacked = {}
                for key in items[0].inputs:
                    ts = [it.inputs[key] for it in items]
                    stacked[key] = torch.stack(ts + [ts[-1]] * pad)  # bucket fill
                out = self.batch_fn(stacked)
                for i, item in enumerate(items):
                    item.future.set_result(out[i])
            except Exception as e:  # noqa: BLE001 — reaches every future of the batch
                for item in items:
                    if not item.future.done():
                        item.future.set_exception(e)

    def close(self, timeout: float = 10.0) -> None:
        """Stop after the items already queued."""
        self.queue.put(None)
        self.thread.join(timeout)


def make_denoise_batch_fn(pipeline, num_steps: int = 20, guidance: float = 1.5):
    """LipsyncPipeline's ``_denoise`` (DeepCache- and CFG-interval-aware,
    its switches read at each batch) as a ``WindowBatcher`` batch function
    over stacked (W, ...) window tensors."""

    def batch_fn(stacked):
        return pipeline._denoise(stacked["latents0"], stacked["mask"], stacked["masked"],
                                 stacked["ref"], stacked["audio"], num_steps, guidance)

    return batch_fn
