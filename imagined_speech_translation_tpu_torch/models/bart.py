"""BART decoder (``fnlp/bart-base-chinese`` family), eval mode.

Port of ``imagined_speech_translation_tpu.models.bart``: shared token
embedding, learned positions (offset 2), ``layernorm_embedding``, post-norm
decoder layers, tied lm_head + ``final_logits_bias``.  Incremental decoding
keeps a fixed-size KV cache per layer (``init_cache``) written in place at
``index``.  The EEG pseudo-encoder is a tiled sequence, so cross-attention
over it is the identity on V: ``cross_attn_const`` hoists it out of the decode
loop as one ``out_proj(v_proj(vec))`` per layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagined_speech_translation_tpu.config import BartConfig

from ..ops import dot_product_attention


def pseudo_encoder_sequence(proj_eeg: torch.Tensor, length: int) -> torch.Tensor:
    """Tile a ``(B, d)`` projected EEG feature to ``(B, length, d)``."""
    return proj_eeg[:, None, :].expand(-1, length, -1)


class _BartAttention(nn.Module):
    """HF ``BartAttention`` with an optional in-place KV cache."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        self.d, self.num_heads = d, num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def _split(self, t):
        b, s, _ = t.shape
        return t.reshape(b, s, self.num_heads, self.d // self.num_heads).transpose(1, 2)

    def uniform_const(self, vec):
        """Cross-attention output when every key/value position holds ``vec``
        (B, d): softmax weights are uniform, so attention returns v itself."""
        return self.out_proj(self.v_proj(vec))

    def forward(self, x, kv=None, mask=None, *, cache=None):
        kv = x if kv is None else kv
        q = self._split(self.q_proj(x))
        k = self._split(self.k_proj(kv))
        v = self._split(self.v_proj(kv))
        if cache is not None:
            idx = cache["index"]
            cache["k"][:, :, idx : idx + k.shape[2]] = k
            cache["v"][:, :, idx : idx + v.shape[2]] = v
            cache["index"] = idx + x.shape[1]
            k, v = cache["k"], cache["v"]
        out = dot_product_attention(q, k, v, mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(x.shape[:-1] + (self.d,)))


class _BartDecoderLayer(nn.Module):
    """Post-norm decoder layer (HF ``BartDecoderLayer``)."""

    def __init__(self, cfg: BartConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _BartAttention(d, cfg.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_attn = _BartAttention(d, cfg.num_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, encoder_hidden, self_mask, cross_mask=None, *, cache=None,
                cross_const=None):
        x = self.self_attn_layer_norm(x + self.self_attn(x, mask=self_mask, cache=cache))
        if cross_const is not None:
            a = cross_const[:, None, :]
        else:
            a = self.encoder_attn(x, kv=encoder_hidden, mask=cross_mask)
        x = self.encoder_attn_layer_norm(x + a)
        f = self.fc2(F.gelu(self.fc1(x)))  # BART's exact (erf) GELU
        return self.final_layer_norm(x + f)


class BartDecoderModel(nn.Module):
    """Decoder + tied lm_head.  Full-sequence mode: ``caches=None``, causal
    mask.  Incremental mode: 1-token inputs with explicit ``positions``,
    ``caches`` from :meth:`init_cache`, and ``cross_consts`` from
    :meth:`cross_attn_const`."""

    def __init__(self, cfg: BartConfig):
        super().__init__()
        if not cfg.tie_word_embeddings:
            raise NotImplementedError("only the tied lm_head is ported")
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Parameter(
            torch.empty(cfg.max_position_embeddings + cfg.position_offset, cfg.d_model)
        )
        self.layernorm_embedding = nn.LayerNorm(cfg.d_model, eps=1e-5)
        for li in range(cfg.decoder_layers):
            self.add_module(f"layer{li}", _BartDecoderLayer(cfg))
        self.final_logits_bias = nn.Parameter(torch.empty(cfg.vocab_size))

    def layers(self):
        return [getattr(self, f"layer{li}") for li in range(self.cfg.decoder_layers)]

    def cross_attn_const(self, enc_vec):
        """Per-layer constant cross-attention outputs for a TILED
        pseudo-encoder built from ``enc_vec`` (B, d)."""
        return [layer.encoder_attn.uniform_const(enc_vec) for layer in self.layers()]

    def forward(self, decoder_input_ids, encoder_hidden_states=None,
                encoder_attention_mask=None, *, positions=None, caches=None,
                cross_consts=None):
        cfg = self.cfg
        b, l = decoder_input_ids.shape
        if encoder_hidden_states is None and cross_consts is None:
            raise ValueError("need encoder_hidden_states or cross_consts")
        x = self.shared(decoder_input_ids)
        if cfg.scale_embedding:
            x = x * (cfg.d_model**0.5)
        dev = decoder_input_ids.device
        if positions is None:
            positions = torch.arange(l, device=dev)[None].expand(b, l)
        x = self.layernorm_embedding(x + self.embed_positions[positions + cfg.position_offset])

        if caches is None:
            i = torch.arange(l, device=dev)
            self_mask = (i[None, :] <= i[:, None])[None, None]  # (1, 1, L, L)
        else:
            # query at absolute position p attends keys [0..p]
            j = torch.arange(caches[0]["k"].shape[-2], device=dev)
            self_mask = j[None, None, None, :] <= positions[:, None, :, None]
        cross_mask = None
        if encoder_attention_mask is not None:
            cross_mask = encoder_attention_mask[:, None, None, :].bool()

        for li, layer in enumerate(self.layers()):
            x = layer(
                x, encoder_hidden_states, self_mask, cross_mask,
                cache=None if caches is None else caches[li],
                cross_const=None if cross_consts is None else cross_consts[li],
            )
        return F.linear(x, self.shared.weight) + self.final_logits_bias

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32, device=None):
        hd = self.cfg.d_model // self.cfg.num_heads
        shape = (batch, self.cfg.num_heads, max_length, hd)
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "index": 0}
            for _ in range(self.cfg.decoder_layers)
        ]
