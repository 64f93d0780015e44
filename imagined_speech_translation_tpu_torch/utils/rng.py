"""Deterministic randomness.

Port of ``imagined_speech_translation_tpu.utils.rng``.  The JAX function
seeds python and numpy and returns the root JAX key; here the root of every
random draw is a seed: the trainer builds its weights and its dropout
generators from explicit seeds, so :func:`seed_everything` seeds python,
numpy and torch's global generators (CPU and CUDA) and returns the seed.

:class:`RngStream` hands out a deterministic sequence of ``torch.Generator``
s, as the JAX class hands out keys: the children of a numpy
``SeedSequence`` rooted at the seed, each seeding one generator on the
device asked for.  Its bits never equal the JAX keys'.
"""

from __future__ import annotations

import random

import numpy as np
import torch

# entropy word that keeps fold()'s sequences apart from next()'s children
_FOLD = 0x6F6C64


def seed_everything(seed: int) -> int:
    """Seed python, numpy and torch's global generators; returns ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class RngStream:
    """A deterministic sequence of ``torch.Generator`` s from one seed.

    ``next()`` and ``next_n(n)`` advance the stream, and ``count`` says by
    how many; ``fold(data)`` derives a generator from the stream's state and
    ``data`` without advancing it (per-sample augmentation, say).  Each
    generator is seeded from its own ``SeedSequence`` child, so the children
    are independent streams.  ``device``: where the generators live (the
    CPU unless asked; a CUDA generator draws CUDA tensors)."""

    def __init__(self, seed: int, device: torch.device | str = "cpu"):
        self._seq = np.random.SeedSequence(int(seed))
        self._device = torch.device(device)
        self._count = 0

    def _generator(self, seq: np.random.SeedSequence) -> torch.Generator:
        seed = int(seq.generate_state(1, np.uint64)[0])
        return torch.Generator(device=self._device).manual_seed(seed)

    def next(self) -> torch.Generator:
        self._count += 1
        return self._generator(self._seq.spawn(1)[0])

    def next_n(self, n: int) -> list[torch.Generator]:
        self._count += n
        return [self._generator(s) for s in self._seq.spawn(n)]

    def fold(self, data: int) -> torch.Generator:
        """A generator derived from (stream state, ``data``) without
        advancing the stream."""
        seq = np.random.SeedSequence(
            (self._seq.entropy, _FOLD, int(data)),
            spawn_key=self._seq.spawn_key + (self._seq.n_children_spawned,))
        return self._generator(seq)

    @property
    def count(self) -> int:
        return self._count
