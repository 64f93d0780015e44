"""EEG -> tokens: bind an ``EEGDecodingModel`` and decode params into one
function.  Port of ``imagined_speech_translation_tpu.decode.generate``
(``build_generate_fn``)."""

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
