"""EEG -> tokens: bind an ``EEGDecodingModel`` (or a bare
``BartDecoderModel``) and decode params into one function.  Port of
``imagined_speech_translation_tpu.decode.generate`` (``build_generate_fn``,
``build_bart_generate_fn``)."""

from __future__ import annotations

import torch

from .search import DecodeParams, beam_search, greedy_search


def build_generate_fn(model, dparams: DecodeParams):
    """Returns ``generate(eeg, channel_mask) -> (B, max_length)`` token ids.

    Beam search when ``dparams.num_beams > 1``, greedy otherwise.  The
    cross-attention over the tiled pseudo-encoder is hoisted out of the
    decode loop as per-layer constants (``EEGDecodingModel.cross_consts``)."""
    K = dparams.num_beams

    @torch.inference_mode()
    def generate(eeg, channel_mask=None):
        b = eeg.shape[0]
        _, enc = model.encode(eeg, channel_mask)
        enc_x = enc.repeat_interleave(K, dim=0) if K > 1 else enc
        caches = model.init_cache(enc_x.shape[0], dparams.max_length, enc.dtype, enc.device)
        consts = model.cross_consts(enc_x)

        def step(tokens, positions, caches):
            return model.decode_step_const(tokens, positions, consts, caches)

        search = beam_search if K > 1 else greedy_search
        return search(step, caches, b, dparams, device=eeg.device)

    return generate


def build_bart_generate_fn(model, dparams: DecodeParams):
    """Returns ``generate(encoder_hidden, encoder_mask=None) -> (B,
    max_length)`` token ids for a bare ``BartDecoderModel`` conditioned on
    precomputed encoder states ``(B, S, d)`` and an optional ``(B, S)`` mask
    (all ones by default).

    Beam search when ``dparams.num_beams > 1`` (states and mask repeated per
    beam), greedy otherwise.  The cross-attention K/V are projections of the
    fixed encoder states, so they are computed once per call
    (``cross_attn_kv``) instead of once per decode step; the ids are the
    same."""
    K = dparams.num_beams

    @torch.inference_mode()
    def generate(encoder_hidden, encoder_mask=None):
        b = encoder_hidden.shape[0]
        if encoder_mask is None:
            encoder_mask = torch.ones(encoder_hidden.shape[:2], dtype=torch.int32,
                                      device=encoder_hidden.device)
        enc_x = encoder_hidden.repeat_interleave(K, dim=0) if K > 1 else encoder_hidden
        mask_x = encoder_mask.repeat_interleave(K, dim=0) if K > 1 else encoder_mask
        caches = model.init_cache(enc_x.shape[0], dparams.max_length, encoder_hidden.dtype,
                                  encoder_hidden.device)
        cross_kvs = model.cross_attn_kv(enc_x)

        def step(tokens, positions, caches):
            return model(tokens, enc_x, mask_x, positions=positions, caches=caches,
                         cross_kvs=cross_kvs)

        search = beam_search if K > 1 else greedy_search
        return search(step, caches, b, dparams, device=encoder_hidden.device)

    return generate
