"""The data-parallel mesh: its axis sizes, which rows a shard holds, and the
train state committed to every rank.

Port of the data part of ``imagined_speech_translation_tpu.parallel.mesh``.
JAX lays one program over a mesh of devices and XLA inserts the collectives;
here a mesh is a record of the axis sizes over the ranks of the process
group (training, one process a rank) or over the devices of one process
(serving, one model replica a device), and the collectives are explicit
(``parallel.data_parallel``).  The batch splits over the ``data`` axis,
jointly over ``("dcn", "data")`` when ``n_dcn > 1``: shard ``dcn_idx *
n_data + data_idx`` holds the contiguous rows of that index, as JAX's
``("dcn", "data")`` spec orders them.  ``channel_mask`` is replicated.

Tensor parallelism over ``model`` (the JAX module's ``_TP_RULES``) is ROADMAP
item 1.7b: ``n_model > 1`` and ``tp=True`` raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .distributed import process_count, process_index

TP_NOT_PORTED = ("tensor parallelism over the model axis (n_model > 1, tp=True) is not ported: "
                 "it is ROADMAP item 1.7b")


@dataclass(frozen=True)
class Mesh:
    """Axis sizes and the mesh's entries, ``prod(sizes)`` of them in
    row-major order: rank numbers (a training mesh) or ``torch.device``\\ s
    of this process (a serving mesh)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def over_ranks(self) -> bool:
        return all(isinstance(d, int) for d in self.devices)

    @property
    def n_batch_shards(self) -> int:
        """The shards the batch splits into: every axis but ``model``."""
        return math.prod(n for a, n in self.shape.items() if a != "model")

    def batch_axes(self):
        return ("dcn", "data") if "dcn" in self.axis_names else "data"

    def shard_index(self, rank: int | None = None) -> int:
        """The batch shard of ``rank`` (default: this process's)."""
        if not self.over_ranks:
            raise ValueError("a serving mesh has one shard per device, not per rank")
        rank = process_index() if rank is None else rank
        if rank not in self.devices:
            raise ValueError(f"rank {rank} is not on the mesh {self.devices}")
        return self.devices.index(rank) // self.shape.get("model", 1)


def make_mesh(
    n_data: int = -1,
    n_model: int = 1,
    *,
    n_dcn: int = 1,
    axis_names: tuple[str, str] = ("data", "model"),
    devices=None,
) -> Mesh:
    """A ``(data, model)`` mesh, ``(dcn, data, model)`` with ``n_dcn > 1``,
    over ``devices``: by default the ranks of the process group (one rank
    outside one); given devices (``"cuda:0"``, ``"cpu"``, repeats allowed)
    make a serving mesh of one replica each.  The sizes and errors are the
    JAX function's; ``n_model > 1`` then raises (ROADMAP 1.7b)."""
    if devices is None:
        devices = list(range(process_count()))
    else:
        devices = [d if isinstance(d, int) else torch.device(d) for d in devices]
    n = len(devices)
    if n_data == -1:
        if n % (n_model * n_dcn):
            raise ValueError(f"{n} devices not divisible by model={n_model} x dcn={n_dcn}")
        n_data = n // (n_model * n_dcn)
    if n_dcn * n_data * n_model > n:
        raise ValueError(f"mesh {n_dcn}x{n_data}x{n_model} needs more than {n} devices")
    if n_model > 1:
        raise NotImplementedError(TP_NOT_PORTED)
    names = (("dcn",) if n_dcn > 1 else ()) + tuple(axis_names)
    sizes = ((n_dcn,) if n_dcn > 1 else ()) + (n_data, n_model)
    return Mesh(names, sizes, tuple(devices[: n_dcn * n_data * n_model]))


@dataclass(frozen=True)
class Sharding:
    """How a leaf lies on a mesh: per dimension ``None`` (whole) or the
    axis name(s) it splits over, as JAX's ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple = ()


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def state_sharding_tree(state, mesh: Mesh, *, tp: bool = False) -> dict[str, Sharding]:
    """Every entry of the state's module replicated (data parallelism)."""
    if tp:
        raise NotImplementedError(TP_NOT_PORTED)
    return {k: replicate(mesh) for k in state.module.state_dict()}


def batch_sharding(mesh: Mesh, batch: dict, *, batch_axis: int = 0) -> dict[str, Sharding]:
    """Shardings for a batch dict: the ``batch_axis`` of every leaf over the
    batch axes, ``channel_mask`` replicated."""

    def spec(k, v):
        if k == "channel_mask" or not hasattr(v, "ndim"):
            return replicate(mesh)
        axes: list = [None] * v.ndim
        axes[batch_axis] = mesh.batch_axes()
        return Sharding(mesh, tuple(axes))

    return {k: spec(k, v) for k, v in batch.items()}


def _rows(v, batch_axis: int, shard: int, n_shards: int):
    n = v.shape[batch_axis]
    if n % n_shards:
        raise ValueError(f"batch of {n} rows not divisible by the mesh's {n_shards} "
                         "batch shards")
    per = n // n_shards
    index = [slice(None)] * v.ndim
    index[batch_axis] = slice(shard * per, (shard + 1) * per)
    return v[tuple(index)]


def split_batch(mesh: Mesh, batch: dict, *, batch_axis: int = 0) -> list[dict]:
    """The batch's shards in mesh order, each with its contiguous rows;
    ``channel_mask`` (and any leaf without a shape) goes to every shard."""
    n = mesh.n_batch_shards
    return [
        {k: v if k == "channel_mask" or not hasattr(v, "ndim") else _rows(v, batch_axis, i, n)
         for k, v in batch.items()}
        for i in range(n)
    ]


def shard_batch(mesh: Mesh, batch: dict, *, batch_axis: int = 0, rank: int | None = None):
    """This rank's rows of ``batch`` (numpy arrays or tensors) on a training
    mesh: shard :meth:`Mesh.shard_index`; ``channel_mask`` whole."""
    i, n = mesh.shard_index(rank), mesh.n_batch_shards
    return {k: v if k == "channel_mask" or not hasattr(v, "ndim") else _rows(v, batch_axis, i, n)
            for k, v in batch.items()}


@torch.no_grad()
def broadcast_tensors(tensors, src: int = 0) -> None:
    """Overwrite contiguous ``tensors`` on every rank with rank ``src``'s,
    bit for bit: they travel as bytes, which every backend carries (gloo has
    no bfloat16)."""
    for t in tensors:
        dist.broadcast(t.view(-1).view(torch.uint8), src)


def shard_train_state(state, mesh: Mesh, *, tp: bool = False):
    """Commit a train state to a training mesh: every rank takes the first
    rank's parameters, BatchNorm statistics and optimizer moments, so the
    ranks start equal (JAX replicates the state with ``device_put``)."""
    if tp:
        raise NotImplementedError(TP_NOT_PORTED)
    if not mesh.over_ranks:
        raise ValueError("a train state is committed over the ranks of a training mesh")
    if process_count() > 1:
        opt = state.opt_state
        broadcast_tensors([*state.module.state_dict().values(), *opt.mu.values(),
                           *opt.nu.values()], src=mesh.devices[0])
    return state

