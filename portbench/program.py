"""The system under test, built through the port's own entry points from a
configuration tree and the benchmark's weights: ``cli.serve.build_decode_fn``
(serving) and ``training.make_train_step`` (training).  This is the one
module of the harness that imports the port."""

from __future__ import annotations

import numpy as np
import torch

from imagined_speech_translation_tpu_torch.cli.serve import build_decode_fn
from imagined_speech_translation_tpu_torch.config import Config, replace_nested
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, RegionSpec
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from imagined_speech_translation_tpu_torch.training import (
    AdaptiveLossScheduler,
    FusedAdamW,
    create_train_state,
    get_top_k_vocab_indices,
    make_train_step,
)
from imagined_speech_translation_tpu_torch.training.train_state import TrainModule

from . import inputs

__all__ = ["config", "serving", "training", "RecordingTokenizer"]


def config(tree: dict, pins: dict | None = None) -> Config:
    """The port's ``Config`` of a configuration tree, with the traffic's
    pinned fields (dotted paths) set."""
    cfg = Config.from_dict(tree)
    for path, value in (pins or {}).items():
        cfg = replace_nested(cfg, path, value)
    return cfg.validate()


class RecordingTokenizer(ChineseCharTokenizer):
    """The serving tokenizer; it also keeps every batch of token ids the
    decode function hands it (the served ids, read after the window)."""

    def __init__(self, vocab):
        super().__init__(vocab)
        self.record: list[np.ndarray] = []

    def batch_decode(self, batch_ids, **kw):
        self.record.append(np.asarray(batch_ids))
        return super().batch_decode(batch_ids, **kw)


def _load(module: torch.nn.Module, seed: int, device) -> list[tuple[str, tuple]]:
    """Fill ``module``'s parameters and buffers with the benchmark's weights
    of ``seed``; returns their ``(name, shape)`` spec."""
    state = module.state_dict()
    spec = [(n, tuple(t.shape)) for n, t in state.items()]
    w = inputs.weights(spec, seed, device)
    with torch.no_grad():
        for n, t in state.items():
            t.copy_(w[n])
    return spec


def serving(cfg: Config, seed: int, device, compute_dtype, n_channels: int):
    """``(decode_fn, tokenizer, montage, weights spec)``: the serving decode
    function over the benchmark's weights, BatchNorm folded, cast to
    ``compute_dtype``, as ``cli.serve`` serves it."""
    tok = RecordingTokenizer(inputs.vocab(cfg.model.bart.vocab_size))
    labels = inputs.montage(n_channels)
    spec = RegionSpec.from_channel_names(labels)
    with torch.device("meta"):
        model = EEGDecodingModel(cfg.model, cfg.data.n_timepoints)
    model = model.to_empty(device=device)
    wspec = _load(model, seed, device)
    decode_fn = build_decode_fn(cfg, tok, spec, model, device=device, fold_bn=True,
                                compute_dtype=compute_dtype)
    return decode_fn, tok, labels, wspec


def training(cfg: Config, seed: int, device, total_steps: int):
    """``(state, train_step, bow_indices, weights spec)``: the default
    training step (``make_train_step``, fused AdamW, composite loss) over
    the benchmark's weights."""
    tok = ChineseCharTokenizer(inputs.vocab(cfg.model.bart.vocab_size))
    bow = get_top_k_vocab_indices(tok, cfg.training.loss.bow_vocab_size)
    with torch.device("meta"):
        module = TrainModule(cfg, len(bow))
    module = module.to_empty(device=device)
    wspec = _load(module, seed, device)
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     total_steps=total_steps)
    state = create_train_state(module, opt,
                               AdaptiveLossScheduler(cfg.training.loss).initial_weights())
    return state, make_train_step(module, opt, cfg, bow), bow, wspec
