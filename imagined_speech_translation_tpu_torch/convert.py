"""Flax variables of the JAX package -> the port's ``state_dict``.

The input is a JAX module's variables as a nested dict of arrays (numpy, or
anything ``np.asarray`` takes) with the collections ``params`` and
``batch_stats``: the ``EEGDecodingModel``'s or one of its submodules', or the
training ``TrainModule``'s, whose trees nest them under ``model`` and
``loss_heads`` (``params.model.*``, ``params.loss_heads.*``,
``batch_stats.model.*``) as the port's ``training.TrainModule`` does.  The
port's modules carry the flax names, so a leaf's path is its key; only the
leaf and the layout change:

* Dense ``kernel (…, in, out)`` -> ``weight (…, out, in)``;
* Conv ``kernel (…, k, in/g, out)`` -> ``weight (…, out, in/g, k)``;
* LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``;
* BatchNorm stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
* Embed ``embedding`` -> ``weight``; other parameters keep name and shape.

The leading region axis that ``nn.vmap`` stacks on every ``region_encoders``
leaf is the port's own region axis, so it passes through.  Conversion is
strict: a leaf with no counterpart, a port tensor left unset, or a shape
mismatch raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.layers import RegionConv, RegionLinear

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_leaf(model: nn.Module, collection: str, path: tuple, value: np.ndarray):
    *mod_path, leaf = path
    key_prefix = "".join(p + "." for p in mod_path)
    try:
        module = model.get_submodule(".".join(mod_path))
    except AttributeError:
        raise KeyError(f"flax variable {collection}/{'/'.join(path)} has no port module") from None
    if collection == "batch_stats":
        if leaf not in _STATS:
            raise KeyError(f"unmapped batch stat {'/'.join(path)}")
        return key_prefix + _STATS[leaf], value
    if collection != "params":
        raise KeyError(f"unmapped flax collection {collection!r}")
    if leaf == "kernel":
        if isinstance(module, (nn.Linear, RegionLinear)):
            return key_prefix + "weight", np.swapaxes(value, -1, -2)
        if isinstance(module, (nn.Conv1d, RegionConv)):
            return key_prefix + "weight", np.swapaxes(value, -1, -3)
        raise KeyError(f"kernel {'/'.join(path)} maps to a {type(module).__name__}")
    if leaf in ("scale", "embedding"):
        return key_prefix + "weight", value
    return key_prefix + leaf, value


def convert_variables(variables, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map flax ``variables`` onto ``model``'s state_dict keys (strict)."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            key, value = _port_leaf(model, collection, path, np.asarray(leaf, np.float32))
            if key not in target:
                raise KeyError(f"flax variable {collection}/{'/'.join(path)} -> {key}: "
                               "no such port tensor")
            if key in out:
                raise KeyError(f"two flax variables map to {key}")
            if tuple(value.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: flax shape {value.shape} != port "
                                 f"{tuple(target[key].shape)}")
            out[key] = torch.tensor(value)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port tensors without a flax variable: {missing}")
    return out


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Load converted flax ``variables`` into ``model`` in place."""
    model.load_state_dict(convert_variables(variables, model), strict=True)
    return model
