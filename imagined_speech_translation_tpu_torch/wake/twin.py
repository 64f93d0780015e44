"""PyTorch twin of the wake detector.

Port of ``imagined_speech_translation_tpu.wake.jax_twin``: a small conv + MLP
over ``(B, T, 2)`` (time, velocity) sequences that predicts the event's
averaged row, trained with Adam on full batches.  The layers, their order,
their flax names and the flattening order are the JAX module's, so the JAX
twin's flax ``params`` load into it (:func:`state_dict_from_flax`):

1. ``conv1``: 2 -> 32, kernel 9, ``SAME``; relu; max-pool 2/2 (floor, as flax
   ``VALID``);
2. ``conv2``: 32 -> 64, kernel 5, ``SAME``; relu; max-pool 2/2;
3. flatten time-major, as flax flattens ``(B, T/4, 64)``;
4. ``fc1`` to ``hidden``, relu; ``fc2`` to ``n_classes``.

flax infers ``fc1``'s fan-in from the input; here the module takes
``seq_len``.  Weights are initialised as flax does (lecun-normal kernels, a
normal truncated at two standard deviations; zero biases) from an explicit
seed or ``torch.Generator``; the bits never equal JAX's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated lecun-normal: the standard deviation of a unit normal
# truncated to [-2, 2] is this, so the draw is divided by it
_TRUNC_STD = 0.87962566103423978


class WakeMLP(nn.Module):
    """``(B, T, 2)`` (time, velocity) features -> ``(B, n_classes)``
    event-time logits."""

    def __init__(self, seq_len: int, n_classes: int, hidden: int = 128):
        super().__init__()
        self.conv1 = nn.Conv1d(2, 32, 9, padding=4)
        self.conv2 = nn.Conv1d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(seq_len // 2 // 2 * 64, hidden)
        self.fc2 = nn.Linear(hidden, n_classes)

    def forward(self, x):
        x = x.transpose(1, 2)  # (B, F, T): channel-first for conv1d
        x = F.max_pool1d(F.relu(self.conv1(x)), 2)
        x = F.max_pool1d(F.relu(self.conv2(x)), 2)
        x = x.transpose(1, 2).flatten(1)  # flax's (B, T/4, 64) row order
        return self.fc2(F.relu(self.fc1(x)))


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


@torch.no_grad()
def init_wake_params(model: WakeMLP, rng) -> WakeMLP:
    """Fill ``model`` in place as flax initialises ``WakeMLP``: each kernel
    from a normal truncated to two standard deviations, scaled to variance
    1 / fan_in; biases zero.  ``rng``: a seed or a CPU ``torch.Generator``;
    the values are drawn on the CPU, so a seed gives the same weights on any
    device."""
    g = _generator(rng)
    for layer in (model.conv1, model.conv2, model.fc1, model.fc2):
        w = layer.weight
        fan_in = w.shape[1:].numel()
        draw = torch.empty(w.shape)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=g)
        w.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        layer.bias.zero_()
    return model


def state_dict_from_flax(params, model: WakeMLP) -> dict[str, torch.Tensor]:
    """The JAX twin's flax ``params`` (numpy) as ``model``'s state dict: conv
    ``(k, in, out)`` -> ``(out, in, k)``, dense ``(in, out)`` -> ``(out,
    in)``, strictly (``convert.convert_variables``)."""
    from ..convert import convert_variables

    return convert_variables({"params": params}, model)


def make_wake_train_step(model: WakeMLP, learning_rate: float = 1e-3):
    """Returns ``(init_fn, step_fn, predict_fn)`` for batched training, as
    the JAX function does, on the device ``model`` lies on:

    * ``init_fn(rng) -> (model, optimizer)``: ``model`` initialised in place
      from ``rng`` (a seed or a ``torch.Generator``) and a fresh Adam with
      optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), which
      ``torch.optim.Adam`` computes;
    * ``step_fn(model, optimizer, x, labels) -> (model, optimizer, loss)``:
      one step on the mean softmax cross-entropy over integer labels, in
      place (both are returned for the JAX function's shape); ``loss`` is a
      0-d tensor;
    * ``predict_fn(model, x)``: argmax of the logits, under ``no_grad``.
    """

    def init_fn(rng):
        init_wake_params(model, rng)
        return model, torch.optim.Adam(model.parameters(), lr=learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8)

    def step_fn(model, optimizer, x, labels):
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), labels)
        loss.backward()
        optimizer.step()
        return model, optimizer, loss.detach()

    @torch.no_grad()
    def predict_fn(model, x):
        return model(x).argmax(dim=-1)

    return init_fn, step_fn, predict_fn
