"""Tensor parallelism over the mesh's ``model`` axis (Megatron layout).

The counterpart of what XLA inserts from the JAX package's ``_TP_RULES``
(``parallel.mesh``): a column-parallel layer holds this rank's output
columns (or heads) and a row-parallel layer this rank's input rows, and the
collectives are explicit, over the ranks that share a batch shard (the
model group):

* :func:`copy_to_model` (Megatron's *f*): the identity forward, a sum over
  the model group in the backward; it enters every column-parallel block,
  whose input is replicated;
* :func:`reduce_from_model` (*g*): a sum over the model group forward, the
  identity backward; it leaves every row-parallel block, before the bias;
* :func:`gather_cols`: every rank's columns, concatenated, whose backward
  keeps this rank's columns (the gradient of a replicated computation is the
  same on every rank);
* :func:`cols` keeps this rank's columns of a replicated tensor, and
  :func:`model_cols` does so for a dropout mask drawn at the full shape, so
  the generator advances as on one device and the bits are the same
  (``parallel.data_parallel.global_rows`` does the same for rows).

Everything outside the sharded blocks runs replicated on the model group,
so the gradients of replicated parameters are equal on its ranks and only
the data group sums them.  The wire is float32 (gloo has no bfloat16); under
gloo a gather of CUDA tensors is staged through host memory, since gloo
gathers host tensors.

The context (:func:`installed`) is process-wide, not per thread: the
autograd engine runs a CUDA backward on its own thread.  Without it every
function here is the identity, and nothing changes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the model axis: index ``rank`` of ``world``,
    reduced over ``group``; ``dims`` maps each sharded state-dict key to the
    torch dimension that splits (the moments of a parameter split alike)."""

    rank: int
    world: int
    group: object = None
    dims: dict = field(default_factory=dict)

    def local(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t``, the whole tensor of the split entry
        ``key``."""
        dim = self.dims[key]
        if t.shape[dim] % self.world:
            raise ValueError(f"{key}: dimension {dim} of {tuple(t.shape)} does not split over "
                             f"{self.world} model ranks")
        w = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * w, w)


class _State:
    tp: TensorParallel | None = None


@contextlib.contextmanager
def installed(tp: TensorParallel | None):
    """Run a forward and backward with sharded blocks under ``tp`` (None:
    as on one device)."""
    saved = _State.tp
    _State.tp = tp
    try:
        yield
    finally:
        _State.tp = saved


def active() -> TensorParallel | None:
    return _State.tp


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.float().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in group
    order; float32 on the wire, through host memory for CUDA tensors under
    gloo.  ``t`` itself in one process."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    wire = t.float().contiguous()
    if wire.is_cuda and dist.get_backend(group) == "gloo":
        wire = wire.cpu()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, tp, dim):
        ctx.tp, ctx.dim, ctx.width = tp, dim, t.shape[dim]
        return all_gather(t, tp.group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.width, ctx.width), None, None


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``t`` forward, its gradient summed over the model
    group backward."""
    tp = _State.tp
    return t if tp is None else _CopyToModel.apply(t, tp.group)


def reduce_from_model(t: torch.Tensor) -> torch.Tensor:
    """Megatron's *g*: ``t`` summed over the model group forward, the
    gradient passed through backward."""
    tp = _State.tp
    return t if tp is None else _ReduceFromModel.apply(t, tp.group)


def gather_cols(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's columns of ``t`` (along ``dim``), in rank order."""
    tp = _State.tp
    return t if tp is None else _GatherCols.apply(t, tp, dim % t.dim())


def cols(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This model rank's columns of the replicated ``t`` along ``dim``."""
    tp = _State.tp
    if tp is None:
        return t
    if t.shape[dim] % tp.world:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over "
                         f"{tp.world} model ranks")
    w = t.shape[dim] // tp.world
    return t.narrow(dim, tp.rank * w, w)


def model_cols(shape, dim: int):
    """``(full_shape, take)`` for a tensor of ``shape`` that holds this
    rank's columns along ``dim``: the shape of the single-device tensor and
    the function that keeps this rank's columns of one.  None outside a
    context."""
    tp = _State.tp
    if tp is None:
        return None
    dim = dim % len(shape)
    full = list(shape)
    full[dim] = shape[dim] * tp.world
    return tuple(full), lambda t: t.narrow(dim, tp.rank * shape[dim], shape[dim])
