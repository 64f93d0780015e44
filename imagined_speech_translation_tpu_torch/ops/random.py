"""Dropout randomness from an explicit generator.

The JAX package draws every dropout mask from the ``dropout`` key of the
step (``self.make_rng('dropout')`` at each use).  The port takes one CPU
``torch.Generator`` per forward instead; each use draws an int32 seed from
it on the host (no device work, so no synchronisation) and either hands the
seed to the flash kernel or seeds a generator on the tensor's device for an
elementwise mask.  The same generator state therefore gives the same masks,
on the CPU and, for a given card, on the card.

Under data parallelism (``parallel.data_parallel``) a mask is drawn at the
global batch's shape and the rank keeps its rows, so each rank drops what
the single-device step drops in those rows; under tensor parallelism
(``parallel.tensor_parallel``) a mask of a sharded activation is drawn at
the full width and the rank keeps its columns or heads (``model_dim``).
"""

from __future__ import annotations

import torch

from ..parallel import data_parallel, tensor_parallel

_INT32_MAX = 2**31 - 1


def draw_seed(generator: torch.Generator) -> int:
    """An int32 seed in ``[0, 2**31 - 1)`` from a CPU generator, as the JAX
    package's ``jax.random.randint(key, (), 0, int32 max)``."""
    return int(torch.randint(0, _INT32_MAX, (), generator=generator))


def bernoulli_keep(shape, keep_prob: float, device, generator: torch.Generator, *,
                   batch_dim: int = 0, model_dim: int | None = None) -> torch.Tensor:
    """Boolean mask of ``shape``, each entry True with ``keep_prob``, drawn on
    ``device`` by a generator there seeded with one draw from ``generator``;
    under data parallelism this rank's rows, along ``batch_dim``, of the
    global batch's mask, and under tensor parallelism its columns along
    ``model_dim`` (None: the tensor is replicated over the model axis)."""
    on_device = torch.Generator(device=device).manual_seed(draw_seed(generator))
    takes = []
    cols = None if model_dim is None else tensor_parallel.model_cols(shape, model_dim)
    if cols is not None:
        shape, take = cols
        takes.append(take)
    rows = data_parallel.global_rows(shape, batch_dim)
    if rows is not None:
        shape, take = rows
        takes.append(take)
    keep = torch.bernoulli(torch.full(shape, keep_prob, device=device), generator=on_device).bool()
    for take in reversed(takes):
        keep = take(keep)
    return keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None, *,
            model_dim: int | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``: with a generator, zero each entry with
    probability ``rate`` and divide the rest by ``1 - rate``; without one
    (eval mode) the identity.  The batch rows lie on
    ``data_parallel.batch_dim()``; ``model_dim`` names the dimension that a
    tensor-parallel block splits."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = bernoulli_keep(x.shape, keep_prob, x.device, generator,
                          batch_dim=data_parallel.batch_dim(), model_dim=model_dim)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
