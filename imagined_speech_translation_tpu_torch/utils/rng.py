"""Deterministic seeding.

Port of ``imagined_speech_translation_tpu.utils.rng.seed_everything``.  The
JAX function seeds python and numpy and returns the root JAX key; here the
root of every random draw is a seed: the trainer builds its weights and its
dropout generators from explicit seeds, so this seeds python, numpy and
torch's global generators (CPU and CUDA) and returns the seed.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    """Seed python, numpy and torch's global generators; returns ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed
