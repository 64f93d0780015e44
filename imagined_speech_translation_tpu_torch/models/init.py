"""Deterministic random initialization of the port's own modules.

Used when there are no converted weights (smoke runs, benchmarks): every
parameter and buffer is drawn from one CPU ``torch.Generator`` seeded by the
caller, so a seed gives the same weights on any device.  Kernels get a
fan-in scaled normal (as flax's lecun-normal, untruncated), biases zero,
norms identity, tokens and embeddings normal(0.02) and the region importance
normal(0.5), as the JAX package's initializers do.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig

from .eeg_model import EEGDecodingModel
from .layers import RegionConv, RegionLayerNorm, RegionLinear, RegionNorm

_DENSE = (nn.Linear, nn.Conv1d, RegionLinear, RegionConv)
_NORMS = (nn.LayerNorm, RegionLayerNorm, RegionNorm)


def _value(module: nn.Module, name: str, t: torch.Tensor, g: torch.Generator):
    def normal(std):
        return torch.randn(t.shape, generator=g) * std

    if name == "bias" or name == "final_logits_bias" or name == "running_mean":
        return torch.zeros(t.shape)
    if isinstance(module, _NORMS) and name in ("weight", "running_var"):
        return torch.ones(t.shape)
    if isinstance(module, _DENSE) and name == "weight":
        stacked = isinstance(module, (RegionLinear, RegionConv))
        fan_in = t[0].shape[1:].numel() if stacked else t.shape[1:].numel()
        return normal(fan_in**-0.5)
    if name == "region_importance":
        return normal(0.5)
    if isinstance(module, nn.Embedding) or name in (
        "cls_token", "temporal_tokens", "pos_emb", "region_embeddings", "embed_positions",
    ):
        return normal(0.02)
    raise ValueError(f"no initializer for {type(module).__name__}.{name}")


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer of ``model`` in place from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    for _, module in model.named_modules():
        tensors = list(module.named_parameters(recurse=False))
        tensors += list(module.named_buffers(recurse=False))
        for name, t in tensors:
            t.copy_(_value(module, name, t, g))
    return model


def build_model(cfg: ModelConfig, n_timepoints: int, *, seed: int,
                device: torch.device | str = "cuda") -> EEGDecodingModel:
    """An eval-mode float32 :class:`EEGDecodingModel` on ``device`` (the card
    unless the caller asks for the CPU) with random weights from ``seed``
    (allocated there directly, initialized once)."""
    with torch.device("meta"):
        model = EEGDecodingModel(cfg, n_timepoints)
    model = model.to_empty(device=device)
    return init_parameters(model, seed).eval()
