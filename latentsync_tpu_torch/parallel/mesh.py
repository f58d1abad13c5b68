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

Serving across cards (the mesh's ``data`` and ``model`` axes,
``latentsync_tpu/parallel/mesh.py:21-71``): :func:`make_mesh` lays the
ranks of a launch out as a dp × tp grid, rows ``data`` and columns
``model``, with a process group for each row and each column.
:func:`batch_sharding` gives a rank its slice of the leading window axis,
:func:`param_tp_sharding` the JAX rule for which parameters shard their
output-feature dim over ``model`` (dim 0 in the upstream layout of
``Linear`` and ``Conv`` weights, the last in flax), and
:func:`tensor_parallel_` keeps only this rank's shard of each such
parameter in a module. There, as XLA's partitioner does for a product with
an output-sharded operand, a plain ``nn.Linear`` / ``nn.Conv2d`` computes
its own output shard and all-gathers it along the channel dim; any other
read of a sharded weight (a hand kernel's operand, the int8 route) gets the
whole weight, all-gathered at the read, as XLA replicates a custom call's
operands. :func:`data_parallel_call` runs a function on this rank's
windows and gathers the result back to every rank. A collective that
fails raises; nothing falls back to one rank.
"""

from __future__ import annotations

import math
import os
import types
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import parametrize

from ..ops.qconv import QConv2d, int8_enabled

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


# ---------------------------------------------------------------------------
# serving across cards: the mesh's data and model axes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A dp × tp grid of the launch's first dp·tp ranks, rank r at row
    ``r // tp`` (its place on the ``data`` axis) and column ``r % tp`` (on
    the ``model`` axis). `data_group` joins this rank's column (the ranks
    that hold the same shards and split the windows), `model_group` its
    row (the ranks that split the weights); both None without a process
    group, where dp and tp are 1. A rank past the grid is no `member`."""

    dp: int = 1
    tp: int = 1
    rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.tp}

    @property
    def member(self) -> bool:
        return self.rank < self.dp * self.tp

    def index(self, axis: str) -> int:
        return self.rank // self.tp if axis == "data" else self.rank % self.tp

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """The grid over the first `n_devices` ranks of the process group (all
    of them by default), `model_parallel` to a row. Every rank of the
    process group must call it, in the same order, members or not: each
    row's and each column's group is made on all of them. Without a
    process group the mesh is the one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_devices or 1) != 1 or model_parallel != 1:
            raise RuntimeError(f"make_mesh({n_devices}, {model_parallel}): no process group; "
                               "launch under torch.distributed.run")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n > world or n % model_parallel:
        raise ValueError(f"make_mesh: {n} ranks of {world} do not make rows of "
                         f"{model_parallel}")
    dp, tp = n // model_parallel, model_parallel
    data_group = model_group = None
    for d in range(dp):  # rows: the model axis
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d and rank < n:
            model_group = g
    for m in range(tp):  # columns: the data axis
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m and rank < n:
            data_group = g
    return Mesh(dp, tp, rank, data_group, model_group)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The pieces of `t` of every rank on `axis`, concatenated along `dim`
    in the axis's order (one collective; `t` itself where the axis has one
    rank and no group)."""
    group, n = mesh.group(axis), mesh.shape[axis]
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    all_gather.launches += 1
    return torch.cat(parts, dim=dim)


all_gather.launches = 0


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: split evenly along `dim` over the
    ranks of `axis`, or replicated (`dim` None)."""

    mesh: Mesh
    dim: Optional[int] = None
    axis: Optional[str] = None

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def piece(self, size: int) -> slice:
        """This rank's slice of a dim of `size`; raises unless the axis
        divides it."""
        if not self.sharded:
            return slice(0, size)
        n = self.mesh.shape[self.axis]
        if size % n:
            raise ValueError(f"a dim of {size} does not split over the {n} ranks of the "
                             f"{self.axis!r} axis")
        i = self.mesh.index(self.axis)
        return slice(i * size // n, (i + 1) * size // n)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        if not self.sharded:
            return t
        sl = self.piece(t.shape[self.dim])
        return t.narrow(self.dim, sl.start, sl.stop - sl.start)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t if not self.sharded else all_gather(t, self.mesh, self.axis, self.dim)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (window) axis split over the data axis."""
    return Sharding(mesh, 0, "data")


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def _tp_rule(t: torch.Tensor, tp: int) -> bool:
    """The JAX rule on the port's layout: a weight of ndim >= 2 whose
    output-feature dim (first here, last in flax) divides by tp and is at
    least 8·tp."""
    return t.dim() >= 2 and t.shape[0] % tp == 0 and t.shape[0] >= 8 * tp


def param_tp_sharding(mesh: Mesh, params) -> Dict[str, Sharding]:
    """Name → :class:`Sharding` of every parameter of `params` (a module or
    a state dict): dim 0 over ``model`` where :func:`_tp_rule` holds, else
    replicated."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: Sharding(mesh, 0, "model") if _tp_rule(v, mesh.tp) else replicated(mesh)
            for k, v in params.items()}


def shard_tree(tree: Dict[str, torch.Tensor], shardings: Dict[str, Sharding]):
    """This rank's piece of each tensor of `tree`."""
    return {k: shardings[k].shard(v) for k, v in tree.items()}


class _Gathered(nn.Module):
    """Parametrization: the whole weight from this rank's shard, gathered
    over the model axis at each read."""

    def __init__(self, mesh: Mesh):
        super().__init__()
        self.mesh = mesh

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return all_gather(shard, self.mesh, "model", 0)


def _bias_piece(mod: nn.Module, mesh: Mesh) -> Optional[torch.Tensor]:
    if mod.bias is None:
        return None
    return Sharding(mesh, 0, "model").shard(mod.bias)


def _tp_linear(self: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    mesh = self.parametrizations.weight[0].mesh
    y = F.linear(x, self.parametrizations.weight.original, _bias_piece(self, mesh))
    return all_gather(y, mesh, "model", -1)


def _tp_conv(self: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """This rank's output channels, all-gathered; a 5-D input (B, C, F, H,
    W) is convolved per frame, as ``InflatedConv2d``; under the int8 route
    the module's own forward runs on the whole, gathered weight."""
    if isinstance(self, QConv2d) and int8_enabled():
        return type(self).forward(self, x)
    mesh = self.parametrizations.weight[0].mesh
    b = x.shape[0]
    frames = x.dim() == 5
    if frames:
        x = x.transpose(1, 2).flatten(0, 1)
    y = self._conv_forward(x, self.parametrizations.weight.original, _bias_piece(self, mesh))
    y = all_gather(y, mesh, "model", 1)
    return y.unflatten(0, (b, -1)).transpose(1, 2) if frames else y


@torch.no_grad()
def tensor_parallel_(module: nn.Module, mesh: Mesh) -> List[str]:
    """Keep only this rank's shard (:func:`shard_tree`) of every parameter
    :func:`param_tp_sharding` splits over the model axis, and return their
    names. Reading such a weight (``mod.weight``) gathers the whole; a
    plain ``nn.Linear`` / ``nn.Conv2d`` (the ``QConv2d`` family included,
    off the int8 route) holding one computes its output shard and gathers
    that instead. Inference only: nothing here carries a gradient. With
    tp = 1 nothing is split, and the list is empty."""
    if mesh.tp == 1:
        return []
    shardings = param_tp_sharding(mesh, module)
    names = [k for k, s in shardings.items() if s.sharded]
    pieces = shard_tree({k: module.get_parameter(k) for k in names}, shardings)
    for name in names:
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        setattr(owner, leaf, nn.Parameter(pieces[name].clone(), requires_grad=False))
        parametrize.register_parametrization(owner, leaf, _Gathered(mesh), unsafe=True)
        if leaf != "weight" or getattr(owner, "groups", 1) != 1:
            continue
        if isinstance(owner, nn.Linear):
            owner.forward = types.MethodType(_tp_linear, owner)
        elif isinstance(owner, nn.Conv2d):
            owner.forward = types.MethodType(_tp_conv, owner)
    return names


def data_parallel_call(mesh: Mesh, fn: Callable[..., torch.Tensor], *batched,
                       **kwargs) -> torch.Tensor:
    """``fn`` on this rank's slice of each of `batched` along its leading
    (window) axis, the pieces gathered back to every rank in order. Raises
    unless the data axis divides the windows, as the JAX sharding does."""
    sharding = batch_sharding(mesh)
    return sharding.gather(fn(*(sharding.shard(a) for a in batched), **kwargs))
