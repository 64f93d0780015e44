"""Three-group AdamW with warmup-cosine schedules and global-norm clipping.

Port of ``imagined_speech_translation_tpu.training.optimizer``,
``training.fused_optimizer`` and ``utils.trees.label_params_by_substring``:
per-group learning rates by parameter-name substring (``brain_encoder``
3e-4, ``eeg_to_bart`` 1e-4, ``bart`` 3e-5; anything else, such as the loss
heads, trains in the ``projection`` group), one shared warmup + cosine (or
linear) schedule, and clip-by-global-norm before the step.

The update is the JAX package's fused clip + AdamW, written as plain torch
and applied in place (the parameters, ``mu`` and ``nu`` are updated where
they lie, which saves a copy of each at 308M parameters):

* clip: ``scale = 1 if |g| < max_norm else max_norm / |g|``;
* Adam: ``mu' = b1 mu + (1 - b1) g``, ``nu' = b2 nu + (1 - b2) g^2``, with
  bias correction at ``count + 1``;
* the schedule is read at the count BEFORE the increment (optax's
  ``scale_by_schedule``);
* weight decay is decoupled: ``wd * p`` joins the update before the
  learning rate scales it;
* ``mu`` is stored in ``mu_dtype`` (bfloat16 by default) and ``nu`` in
  float32; the arithmetic runs in float32.

Under tensor parallelism (``parallel.tensor_parallel``) a rank holds its
slice of each sharded parameter, its gradient and its moments; the global
norm sums the squares of the sharded gradients over the model group and
counts the replicated ones once, so the clip is the single device's.

``torch.optim.AdamW`` is not used: its moments take the parameters' dtype
and it has no ``mu_dtype``.  The JAX package offers the same update as an
optax chain too (``fused=False``), with the same numerics; the port has the
fused form only, and :func:`build_optimizer` returns it for either setting.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..config import OptimizerConfig

GROUP_RULES = (
    ("encoder", ("brain_encoder",)),
    ("projection", ("eeg_to_bart",)),
    ("bart", ("bart",)),
)
DEFAULT_GROUP = "projection"


def label_params_by_substring(names: Sequence[str], rules, default: str) -> dict[str, str]:
    """Label each parameter name with the first rule whose substring it
    contains, else ``default``."""
    labels = {}
    for name in names:
        labels[name] = next(
            (label for label, subs in rules if any(s in name for s in subs)), default
        )
    return labels


_F = np.float32  # optax evaluates its schedules in float32, step by step


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """optax ``linear_schedule``: ``init`` -> ``end`` over ``steps``, then
    ``end``; constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: _F(init)

    def schedule(count):
        frac = _F(1) - _F(min(max(count, 0), steps)) / _F(steps)
        return _F(init - end) * frac + _F(end)

    return schedule


def _cosine(init: float, steps: int) -> Callable[[int], np.float32]:
    """optax ``cosine_decay_schedule`` with ``alpha = 0``."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {steps}")

    def schedule(count):
        angle = _F(math.pi) * _F(min(count, steps)) / _F(steps)
        return _F(init) * (_F(0.5) * (_F(1) + np.cos(angle)))

    return schedule


def _join(schedules, boundary: int):
    first, second = schedules
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_schedule(base_lr: float, cfg: OptimizerConfig, total_steps: int):
    """Step count -> learning rate, as the JAX package's optax schedules
    (``warmup_cosine_decay_schedule`` from 0, or linear warmup then linear
    decay), with optax's float32 arithmetic."""
    if cfg.schedule == "cosine":
        decay_steps = max(total_steps, cfg.warmup_steps + 1)
        fn = _join((_linear(0.0, base_lr, cfg.warmup_steps),
                    _cosine(base_lr, decay_steps - cfg.warmup_steps)), cfg.warmup_steps)
    elif cfg.schedule == "linear":
        fn = _join((_linear(0.0, base_lr, cfg.warmup_steps),
                    _linear(base_lr, 0.0, max(total_steps - cfg.warmup_steps, 1))),
                   cfg.warmup_steps)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return lambda count: float(fn(int(count)))


def group_lrs(cfg: OptimizerConfig) -> dict[str, float]:
    return {"encoder": cfg.encoder_lr, "projection": cfg.projection_lr, "bart": cfg.bart_lr}


def global_norm(tensors, *, sharded=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in float32; the squares
    of the ``sharded`` tensors (slices of tensors split over the ranks of
    ``group``) summed over the group first."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(norms))
    parts = torch.stack(torch._foreach_norm([t.float() for t in sharded])).square().sum()
    torch.distributed.all_reduce(parts, group=group)
    return (torch.stack(norms).square().sum() + parts).sqrt()


@dataclass
class FusedAdamWState:
    count: int                      # completed steps
    mu: dict[str, torch.Tensor]     # first moment, mu_dtype
    nu: dict[str, torch.Tensor]     # second moment, float32


class FusedAdamW:
    """Clip + three-group AdamW over named float32 parameters."""

    def __init__(self, names: Sequence[str], cfg: OptimizerConfig, total_steps: int):
        self.cfg = cfg
        self.labels = label_params_by_substring(names, GROUP_RULES, DEFAULT_GROUP)
        self.schedules = {name: make_schedule(lr, cfg, total_steps)
                          for name, lr in group_lrs(cfg).items()}
        self.mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None

    def init(self, params: Mapping[str, torch.Tensor]) -> FusedAdamWState:
        return FusedAdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
               state: FusedAdamWState, *, tensor_parallel=None) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the
        global gradient norm before clipping.  With ``tensor_parallel``
        (a ``parallel.tensor_parallel.TensorParallel``) the entries of its
        ``dims`` are this rank's slices."""
        cfg = self.cfg
        b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay
        if tensor_parallel is None:
            g_norm = global_norm(grads.values())
        else:
            dims = tensor_parallel.dims
            g_norm = global_norm([g for n, g in grads.items() if n not in dims],
                                 sharded=[g for n, g in grads.items() if n in dims],
                                 group=tensor_parallel.group)
        clip = torch.where(g_norm < cfg.max_grad_norm, 1.0, cfg.max_grad_norm / g_norm)
        t = torch.tensor(float(state.count + 1), dtype=torch.float32)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
        lrs = {name: s(state.count) for name, s in self.schedules.items()}
        bc1, bc2 = bc1.item(), bc2.item()
        for name, p in params.items():
            gc = grads[name] * clip
            mu = b1 * state.mu[name].float() + (1.0 - b1) * gc
            nu = state.nu[name].mul_(b2).add_((1.0 - b2) * gc.square())
            upd = (mu / bc1) / ((nu / bc2).sqrt() + eps) + wd * p
            p.add_((-lrs[self.labels[name]] * upd).to(p.dtype))
            state.mu[name].copy_(mu)
        state.count += 1
        return g_norm


def build_optimizer(params, cfg: OptimizerConfig, total_steps: int) -> FusedAdamW:
    """The optimizer of ``cfg`` over ``params`` (a mapping of parameter names
    to tensors, or the names).  ``cfg.fused`` selects between two forms of
    one update in the JAX package (``config.py``: the numerics are the same),
    so both settings give :class:`FusedAdamW`."""
    return FusedAdamW(list(params), cfg, total_steps)


def learning_rates_at(cfg: OptimizerConfig, total_steps: int, step) -> dict[str, float]:
    """Each group's learning rate at ``step``, for logging."""
    return {name: make_schedule(lr, cfg, total_steps)(step)
            for name, lr in group_lrs(cfg).items()}
