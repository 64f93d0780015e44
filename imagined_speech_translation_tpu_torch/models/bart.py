"""BART decoder (``fnlp/bart-base-chinese`` family).

Port of ``imagined_speech_translation_tpu.models.bart``: shared token
embedding, learned positions (offset 2), ``layernorm_embedding``, post-norm
decoder layers, tied lm_head + ``final_logits_bias``.  Incremental decoding
keeps a fixed-size KV cache per layer (``init_cache``) written in place at
``index``.  The EEG pseudo-encoder is a tiled sequence, so cross-attention
over it is the identity on V: ``cross_attn_const`` hoists it out of the decode
loop as one ``out_proj(v_proj(vec))`` per layer.

The teacher-forced path also trains: with a ``generator`` the embedding,
residual and FFN activations drop out at ``cfg.dropout`` and attention
probabilities at ``cfg.attention_dropout``, as the JAX module does with
``train=True``; ``return_hidden`` also returns the last decoder states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BartConfig
from ..ops import dot_product_attention, dropout


def pseudo_encoder_sequence(proj_eeg: torch.Tensor, length: int) -> torch.Tensor:
    """Tile a ``(B, d)`` projected EEG feature to ``(B, length, d)``."""
    return proj_eeg[:, None, :].expand(-1, length, -1)


class _BartAttention(nn.Module):
    """HF ``BartAttention`` with an optional in-place KV cache."""

    def __init__(self, d: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d, self.num_heads, self.dropout = d, num_heads, dropout
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

    def forward(self, x, kv=None, mask=None, *, cache=None, generator=None):
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
        out = dot_product_attention(
            q, k, v, mask=mask, dropout_rate=self.dropout if generator is not None else 0.0,
            generator=generator,
        )
        return self.out_proj(out.transpose(1, 2).reshape(x.shape[:-1] + (self.d,)))


class _BartDecoderLayer(nn.Module):
    """Post-norm decoder layer (HF ``BartDecoderLayer``)."""

    def __init__(self, cfg: BartConfig):
        super().__init__()
        d = cfg.d_model
        self.dropout = cfg.dropout
        self.self_attn = _BartAttention(d, cfg.num_heads, cfg.attention_dropout)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.encoder_attn = _BartAttention(d, cfg.num_heads, cfg.attention_dropout)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x, encoder_hidden, self_mask, cross_mask=None, *, cache=None,
                cross_const=None, generator=None):
        def drop(t):
            return dropout(t, self.dropout, generator)

        a = self.self_attn(x, mask=self_mask, cache=cache, generator=generator)
        x = self.self_attn_layer_norm(x + drop(a))
        if cross_const is not None:
            a = cross_const[:, None, :]
        else:
            a = self.encoder_attn(x, kv=encoder_hidden, mask=cross_mask, generator=generator)
        x = self.encoder_attn_layer_norm(x + drop(a))
        f = self.fc2(drop(F.gelu(self.fc1(x))))  # BART's exact (erf) GELU
        return self.final_layer_norm(x + drop(f))


class BartDecoderModel(nn.Module):
    """Decoder + tied lm_head.  Full-sequence mode: ``caches=None``, causal
    mask.  Incremental mode: 1-token inputs with explicit ``positions``,
    ``caches`` from :meth:`init_cache`, and ``cross_consts`` from
    :meth:`cross_attn_const`.  With a ``generator`` (train mode) the
    full-sequence mode applies the JAX module's dropouts."""

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
                cross_consts=None, generator=None, return_hidden=False):
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
        x = dropout(x, cfg.dropout, generator)

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
                generator=generator,
            )
        logits = F.linear(x, self.shared.weight) + self.final_logits_bias
        return (logits, x) if return_hidden else logits

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32, device=None):
        hd = self.cfg.d_model // self.cfg.num_heads
        shape = (batch, self.cfg.num_heads, max_length, hd)
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "index": 0}
            for _ in range(self.cfg.decoder_layers)
        ]
