"""Data-loading infrastructure (basicsr/torch DataLoader parity).

Counterpart of ``latentsync_tpu/training/loader.py``: the same sampler
order (numpy's generator, seeded with seed + epoch) and the same
background prefetch, with the batch moved to the card in the worker
thread (``device``) where the JAX package calls ``jax.device_put``.

- `EnlargedSampler` — re-derivation of ref:basicsr/data/data_sampler.py:
  enlarges a dataset by `ratio` so epoch boundaries don't force restarts
  of iteration-oriented training, with per-epoch seeded shuffling and
  per-host sharding (torch DistributedSampler semantics: rank r takes
  indices r::world).
- `Prefetcher` — host-side analogue of basicsr's CPU/CUDAPrefetcher
  (ref:basicsr/data/prefetch_dataloader.py): a daemon thread keeps a
  bounded queue of ready batches; with a `device` the worker moves each
  batch's arrays there (from pinned host memory, non-blocking), so the
  host-to-device copy overlaps the previous step's compute.
- `BackgroundGenerator`-style iteration for any sample iterable.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class EnlargedSampler:
    """Sharded, epoch-seeded index sampler over `num_samples` items,
    virtually enlarged `ratio`× (ref:basicsr/data/data_sampler.py:8-54)."""

    def __init__(self, num_samples: int, world_size: int = 1, rank: int = 0,
                 ratio: int = 1, shuffle: bool = True, seed: int = 0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world {world_size}")
        self.num_samples = num_samples
        self.world_size = world_size
        self.rank = rank
        self.total = int(np.ceil(num_samples * ratio / world_size)) * world_size
        self.per_rank = self.total // world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.per_rank

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(self.total)
        else:
            order = np.arange(self.total)
        indices = order % self.num_samples
        return iter(indices[self.rank :: self.world_size].tolist())


class Prefetcher:
    """Bounded background prefetch of batches from `make_batch(idx)`.

    `device` (optional) moves each batch — a dict of numpy arrays — to
    that device inside the worker thread, so the copy overlaps the
    previous step's compute, as basicsr's CUDAPrefetcher's side stream
    does."""

    _DONE = object()

    def __init__(
        self,
        index_iter: Iterator,
        make_batch: Callable,
        depth: int = 2,
        device: Optional[str] = None,
    ):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._device = device
        self._thread = threading.Thread(
            target=self._run, args=(index_iter, make_batch), daemon=True
        )
        self._thread.start()

    def _run(self, index_iter, make_batch):
        try:
            for idx in index_iter:
                batch = make_batch(idx)
                if self._device is not None:
                    batch = to_device(batch, self._device)
                self._q.put(batch)
        except BaseException as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device(batch, device) -> dict:
    """A dict of numpy arrays as tensors on `device` (pinned and
    non-blocking where that is the card)."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(value))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


def batched_indices(sampler: Sequence[int] | Iterator[int], batch_size: int,
                    drop_last: bool = True) -> Iterator[list]:
    """Group a sampler's indices into batch-sized lists."""
    buf: list = []
    for i in sampler:
        buf.append(i)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf
