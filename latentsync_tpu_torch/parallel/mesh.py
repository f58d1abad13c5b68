"""Data-parallel training across cards with ``torch.distributed``.

Counterpart of the data axis of ``latentsync_tpu/parallel/mesh.py``, as
the trainers use it (``scripts/train_unet.py:99-104``,
``scripts/train_syncnet.py:60-64``): the JAX package shards the global
batch over ``dp = gcd(batch, devices)`` devices of one mesh and XLA sums
the gradients. Here each of the first ``dp`` ranks of a ``python -m
torch.distributed.run`` launch trains on ``batch / dp`` samples of its
own stream (``HostDataLoader(host_id=rank, num_hosts=dp)``), and the
gradients are averaged across those ranks before the clip over all of them
(:func:`average_`), which is the gradient of the global batch's mean loss,
as DistributedDataParallel's all-reduce gives it. The trainers keep f32
master weights that their forward casts to bf16 inside the graph
(``torch.func.functional_call``), so they sum the gradients themselves, in
buckets as DDP does, rather than through the ``DistributedDataParallel``
wrapper's forward. A rank beyond ``dp`` has nothing to train on: it says
so and exits 0. NCCL on the card, gloo on the CPU; without a launcher
(no ``WORLD_SIZE``) there is one rank and no process group, and every
collective here is a no-op.

The mesh's model axis (``param_tp_sharding``, tensor-parallel serving) has
no counterpart yet.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

# elements a bucket of the gradient all-reduce (100 MB of f32, DDP's default)
_BUCKET = 25 * 2**20


@dataclass(frozen=True)
class DataParallel:
    """This process's place: its rank among the `dp` training ranks."""

    rank: int = 0
    dp: int = 1
    world: int = 1

    @property
    def active(self) -> bool:
        return self.rank < self.dp

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()


def data_parallel_degree(batch: int, devices: int) -> int:
    """The JAX trainers' rule: the degree must divide the global batch."""
    return math.gcd(max(batch, 1), max(devices, 1))


def launch_rank() -> tuple[int, int, int]:
    """(rank, local rank, world size) from a ``torch.distributed.run``
    launch's environment; (0, 0, 1) without one."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return int(os.environ.get("RANK", "0")), int(os.environ.get("LOCAL_RANK", "0")), world


def init_data_parallel(batch: int, device: torch.device) -> DataParallel:
    """Join the ``dp = gcd(batch, world)`` training ranks of this launch. A
    rank beyond them joins nothing and gets ``active`` false. Under a
    launcher (``WORLD_SIZE`` set) the first `dp` ranks form the process
    group (NCCL on a CUDA device, gloo on the CPU; ``MASTER_ADDR`` /
    ``MASTER_PORT`` from the launcher), even where `dp` is 1."""
    rank, _, world = launch_rank()
    dp = data_parallel_degree(batch, world)
    place = DataParallel(rank, dp, world)
    if "WORLD_SIZE" in os.environ and place.active and not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, rank=rank, world_size=dp)
    return place


def card_of_rank(device: str) -> torch.device:
    """`device` itself, or for ``cuda`` the launch's local rank's card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", launch_rank()[1])
    return dev


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    bucket, size = [], 0
    for t in tensors:
        if bucket and (size + t.numel() > _BUCKET or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def average_(tensors: List[torch.Tensor]) -> None:
    """Average `tensors` in place across the process group (one all-reduce
    a bucket of ~100 MB); nothing without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    n = dist.get_world_size()
    for bucket in _buckets([t for t in tensors if t is not None]):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def average_metrics(metrics: Dict[str, float], device: torch.device) -> Dict[str, float]:
    """The mean of each scalar across the process group (a step's loss and
    its components: with equal per-rank batches, the global batch's)."""
    if not (dist.is_available() and dist.is_initialized()):
        return metrics
    keys = sorted(metrics)
    t = torch.tensor([float(metrics[k]) for k in keys], device=device, dtype=torch.float64)
    dist.all_reduce(t)
    return dict(zip(keys, (t / dist.get_world_size()).tolist()))


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Rank `src`'s values of `tensors` on every rank (the master weights
    at the start, so that every rank starts from one model)."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    for t in tensors:
        dist.broadcast(t.data, src)


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
