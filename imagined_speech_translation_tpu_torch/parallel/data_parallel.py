"""The global-batch semantics of a data-parallel train step.

JAX's sharded step is one program over the global micro-batch, so it
computes the single-device function of that batch.  Here each rank runs the
step on its own rows, and the step installs a :class:`DataParallel` context
(:func:`installed`) under which the batch-coupled pieces of the forward take
the global batch into account:

* every rank's loss is its share of the global loss, so the shares sum to
  it and so do the gradients (one all-reduce of sums per optimizer step):
  the cross-entropy divides by the all-reduced count of valid tokens, the
  InfoNCE, diversity and variance terms run on rows gathered from every rank
  (:func:`gather_rows`) and count ``1 / world`` each, the BoW term's mean
  counts ``1 / world``;
* BatchNorm in train mode all-reduces its sums of x and x^2 and its count
  (:func:`all_reduce_sum`, with gradient), so the statistics, and the running
  ones, are the global batch's on every rank;
* each dropout mask is drawn at the global batch's shape and the rank keeps
  its rows (:func:`global_rows`), so the generator advances as in the
  single-device step and the bits are the same; a flash kernel maps its
  heads to the single-device launch's (:func:`dropout_rows`).

Rows are laid out along one batch dimension: 0 by default, 1 in the
region-stacked ``(R, B, ...)`` tensors of the region encoders (:func:`batch_on`).
An attention batch is ``fold * rows`` with a leading fold (the regions).

The context is process-wide, not per thread: the autograd engine runs a
CUDA backward (and a checkpoint's recompute) on its own thread.  Without it
every function here is the identity, and nothing changes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataParallel:
    """This rank's place among the data-parallel ranks: shard ``rank`` of
    ``world``, reduced over ``group`` (None: the default group)."""

    rank: int
    world: int
    group: object = None

    @classmethod
    def of(cls, mesh, group=None) -> "DataParallel":
        """The context of this process on a training mesh."""
        return cls(mesh.shard_index(), mesh.n_batch_shards, group)


class _State:
    dp: DataParallel | None = None
    rows: int = 0      # this rank's micro-batch rows
    batch_dim: int = 0


@contextlib.contextmanager
def installed(dp: DataParallel | None, rows: int):
    """Run the forward and backward of a micro-batch of ``rows`` rows a rank
    under ``dp`` (None: as on one device)."""
    saved = (_State.dp, _State.rows)
    _State.dp, _State.rows = dp, rows
    try:
        yield
    finally:
        _State.dp, _State.rows = saved


def active() -> DataParallel | None:
    return _State.dp


@contextlib.contextmanager
def batch_on(dim: int):
    """Tensors in this block hold the batch rows on dimension ``dim``."""
    saved = _State.batch_dim
    _State.batch_dim = dim
    try:
        yield
    finally:
        _State.batch_dim = saved


def batch_dim() -> int:
    return _State.batch_dim


def global_rows(shape, dim: int):
    """``(global_shape, take)`` for a tensor of ``shape`` whose dimension
    ``dim`` is ``fold * rows``: the shape of the global batch's tensor, and
    the function that keeps this rank's rows of one.  None outside a
    context."""
    dp = _State.dp
    if dp is None:
        return None
    rows = _State.rows
    n = shape[dim]
    if n % rows:
        raise ValueError(f"dimension {dim} of {tuple(shape)} is not a multiple of the "
                         f"{rows} rows of this rank")
    fold = n // rows
    big = list(shape)
    big[dim] = fold * rows * dp.world

    def take(t):
        t = t.unflatten(dim, (fold, rows * dp.world))
        return t.narrow(dim + 1, dp.rank * rows, rows).flatten(dim, dim + 1)

    return tuple(big), take


def dropout_rows(n: int) -> tuple[int, int, int] | None:
    """``(b_local, b_global, b_offset)`` of an attention batch of ``n =
    fold * rows`` (``ops.flash_attention``'s ``dropout_rows``)."""
    dp = _State.dp
    if dp is None:
        return None
    rows = _State.rows
    if n % rows:
        raise ValueError(f"attention batch {n} is not a multiple of the {rows} rows of "
                         "this rank")
    return rows, rows * dp.world, dp.rank * rows


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the gradient of each rank's input is the sum over
    ranks of the gradients of the output (every rank's loss uses it)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (float32 on the
    wire); ``t`` itself outside a context."""
    dp = _State.dp
    if dp is None:
        return t
    return _AllReduceSum.apply(t.float(), dp.group).to(t.dtype)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (dim 0), in rank order, differentiable: the
    global batch's tensor.  The rows travel as a sum of zero-padded blocks,
    which is exact; the backward hands each rank the sum over ranks of the
    gradients of its rows, as ``torch.distributed.nn.functional.all_gather``
    does."""
    dp = _State.dp
    if dp is None:
        return t
    rows = t.shape[0]
    full = t.new_zeros((rows * dp.world,) + t.shape[1:], dtype=torch.float32)
    full = full.index_copy(0, torch.arange(dp.rank * rows, (dp.rank + 1) * rows,
                                           device=t.device), t.float())
    return _AllReduceSum.apply(full, dp.group).to(t.dtype)


@torch.no_grad()
def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, without gradient; ``t`` outside a
    context."""
    dp = _State.dp
    if dp is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=dp.group)
    return out


@torch.no_grad()
def all_reduce_buckets(tensors: list[torch.Tensor], group=None,
                       bucket_bytes: int = 64 << 20) -> None:
    """Sum ``tensors`` over the ranks in place, in flat buckets of at most
    ``bucket_bytes`` (each tensor in one bucket, consecutive tensors of one
    dtype together)."""
    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        bucket, size = [], 0

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > bucket_bytes or t.dtype != bucket[0].dtype):
            flush()
        bucket.append(t)
        size += nbytes
    flush()
