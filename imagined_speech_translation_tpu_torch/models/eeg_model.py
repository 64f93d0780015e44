"""Assembled EEG -> text model.

Port of ``imagined_speech_translation_tpu.models.eeg_model``:
``BrainRegionEncoder`` -> ``eeg_to_bart`` Linear + LayerNorm -> tiled
pseudo-encoder -> ``BartDecoderModel``.

Train mode is the module's ``training`` flag together with a dropout
``generator`` (the JAX module's ``train=True`` with a ``dropout`` key): the
teacher-forced forward takes one in train mode and none in eval mode, so
BatchNorm statistics and dropout always agree.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .bart import BartDecoderModel, pseudo_encoder_sequence
from .brain_encoder import BrainRegionEncoder


class EEGDecodingModel(nn.Module):
    def __init__(self, cfg: ModelConfig, n_timepoints: int):
        super().__init__()
        self.cfg = cfg
        self.brain_encoder = BrainRegionEncoder(
            cfg.brain_encoder, in_channels=cfg.max_region_channels,
            n_timepoints=n_timepoints, n_regions=len(cfg.region_channel_counts),
        )
        self.eeg_to_bart_fc = nn.Linear(cfg.brain_encoder.hidden_dim, cfg.bart.d_model)
        self.eeg_to_bart_ln = nn.LayerNorm(cfg.bart.d_model, eps=1e-6)  # flax default eps
        self.bart = BartDecoderModel(cfg.bart)

    def encode(self, eeg, channel_mask=None, generator=None):
        """EEG -> (fused feature (B, h), pseudo-encoder states (B, S, d))."""
        feat = self.brain_encoder(eeg, channel_mask, generator)
        proj = self.eeg_to_bart_ln(self.eeg_to_bart_fc(feat))
        return feat, pseudo_encoder_sequence(proj, self.cfg.bart.encoder_layers)

    def forward(self, eeg, decoder_input_ids, channel_mask=None, *, generator=None,
                return_aux=False):
        """Teacher-forced logits ``(B, L, V)``; with ``return_aux`` also
        ``{"features": fused EEG feature (B, h), "hidden": last decoder
        states (B, L, d)}``, which the composite loss consumes."""
        if self.training != (generator is not None):
            raise ValueError("pass a dropout generator in train mode, and only then")
        feat, enc = self.encode(eeg, channel_mask, generator)
        mask = torch.ones(enc.shape[:2], dtype=torch.int32, device=enc.device)
        if return_aux:
            logits, hidden = self.bart(decoder_input_ids, enc, mask, generator=generator,
                                       return_hidden=True)
            return logits, {"features": feat, "hidden": hidden}
        return self.bart(decoder_input_ids, enc, mask, generator=generator)

    def cross_consts(self, enc):
        """Per-layer constant cross-attention outputs for the TILED
        pseudo-encoder ``enc`` (B, S, d)."""
        return self.bart.cross_attn_const(enc[:, 0])

    def decode_step_const(self, token, positions, cross_consts, caches):
        """One decode step with hoisted cross-attention constants:
        ``token`` (B, 1) -> logits (B, 1, V); ``caches`` update in place."""
        return self.bart(token, positions=positions, caches=caches, cross_consts=cross_consts)

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32, device=None):
        return self.bart.init_cache(batch, max_length, dtype, device)
