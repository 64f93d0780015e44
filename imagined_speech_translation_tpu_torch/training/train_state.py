"""Train module (model + loss heads) and the train state.

Port of ``imagined_speech_translation_tpu.training.train_state``.
:class:`TrainModule` nests the EEG -> text model with the composite-loss
heads, so both train under one parameter tree (``model.*`` and
``loss_heads.*``, the flax tree's ``model`` / ``loss_heads``) and the
optimizer's substring groups see the reference's names.  :class:`TrainState`
holds the step, the module (float32 master parameters, BatchNorm running
statistics in its buffers), the optimizer state and the loss weights, and,
once ``parallel.shard_train_state(tp=True)`` has kept this rank's slices,
the tensor-parallel layout (``tensor_parallel``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..config import Config
from ..models.eeg_model import EEGDecodingModel
from ..models.init import init_parameters
from .losses import CompositeLossHeads
from ..parallel.tensor_parallel import TensorParallel
from .optimizer import FusedAdamW, FusedAdamWState


class TrainModule(nn.Module):
    """model + composite loss heads under one parameter tree."""

    def __init__(self, cfg: Config, bow_k: int):
        super().__init__()
        self.model = EEGDecodingModel(cfg.model, cfg.data.n_timepoints)
        self.loss_heads = CompositeLossHeads(
            hidden_dim=cfg.model.hidden_dim, bart_dim=cfg.model.bart.d_model, bow_k=bow_k,
        )

    def forward(self, eeg, decoder_input_ids, channel_mask=None, *, generator=None):
        """``(logits, {"features", "hidden"})``; a dropout ``generator`` in
        train mode, none in eval mode."""
        return self.model(eeg, decoder_input_ids, channel_mask, generator=generator,
                          return_aux=True)


@dataclass
class TrainState:
    step: int
    module: TrainModule
    opt_state: FusedAdamWState
    loss_weights: dict[str, float]
    tensor_parallel: TensorParallel | None = None


def build_train_module(cfg: Config, bow_k: int, *, seed: int,
                       device: torch.device | str = "cuda") -> TrainModule:
    """A float32 :class:`TrainModule` on ``device`` (the card unless the
    caller asks for the CPU) with random weights from ``seed``
    (``models.init``'s initializers)."""
    with torch.device("meta"):
        module = TrainModule(cfg, bow_k)
    return init_parameters(module.to_empty(device=device), seed)


def create_train_state(module: TrainModule, optimizer: FusedAdamW,
                       loss_weights: dict[str, float]) -> TrainState:
    return TrainState(
        step=0, module=module, opt_state=optimizer.init(dict(module.named_parameters())),
        loss_weights=dict(loss_weights),
    )
