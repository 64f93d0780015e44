"""Dropout randomness from an explicit generator.

The JAX package draws every dropout mask from the ``dropout`` key of the
step (``self.make_rng('dropout')`` at each use).  The port takes one CPU
``torch.Generator`` per forward instead; each use draws an int32 seed from
it on the host (no device work, so no synchronisation) and either hands the
seed to the flash kernel or seeds a generator on the tensor's device for an
elementwise mask.  The same generator state therefore gives the same masks,
on the CPU and, for a given card, on the card.
"""

from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1


def draw_seed(generator: torch.Generator) -> int:
    """An int32 seed in ``[0, 2**31 - 1)`` from a CPU generator, as the JAX
    package's ``jax.random.randint(key, (), 0, int32 max)``."""
    return int(torch.randint(0, _INT32_MAX, (), generator=generator))


def bernoulli_keep(shape, keep_prob: float, device, generator: torch.Generator) -> torch.Tensor:
    """Boolean mask of ``shape``, each entry True with ``keep_prob``, drawn on
    ``device`` by a generator there seeded with one draw from ``generator``."""
    on_device = torch.Generator(device=device).manual_seed(draw_seed(generator))
    return torch.bernoulli(torch.full(shape, keep_prob, device=device), generator=on_device).bool()


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: with a generator, zero each entry with
    probability ``rate`` and divide the rest by ``1 - rate``; without one
    (eval mode) the identity."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = bernoulli_keep(x.shape, keep_prob, x.device, generator)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
