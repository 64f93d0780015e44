"""BART decoder (``fnlp/bart-base-chinese`` family).

Port of ``imagined_speech_translation_tpu.models.bart``: shared token
embedding, learned positions (offset 2), ``layernorm_embedding``, post-norm
decoder layers, lm_head on the shared embedding (plus ``final_logits_bias``
when ``tie_word_embeddings``; without it the JAX module has no bias, and
neither has this one).  Incremental decoding keeps a fixed-size KV cache per
layer (``init_cache``) written in place at ``index``.  Two loop-invariant
hoists take cross-attention out of the decode loop: ``cross_attn_kv``
projects fixed encoder states to per-layer (k, v) once per generate call
(bit-identical outputs), and, for the EEG pseudo-encoder, which is a tiled
sequence, ``cross_attn_const`` collapses cross-attention to one
``out_proj(v_proj(vec))`` per layer, since attention over identical
positions is the identity on V.

The teacher-forced path also trains: with a ``generator`` the embedding,
residual and FFN activations drop out at ``cfg.dropout`` and attention
probabilities at ``cfg.attention_dropout``, as the JAX module does with
``train=True``; ``return_hidden`` also returns the last decoder states.
``cross_entropy_loss`` is the token-level loss of the teacher-forced logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BartConfig
from ..ops import dot_product_attention, dropout
from ..parallel import data_parallel


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

    def kv(self, kv_in):
        """(k, v) head-split projections of ``kv_in``: loop-invariant for
        fixed encoder states."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def uniform_const(self, vec):
        """Cross-attention output when every key/value position holds ``vec``
        (B, d): softmax weights are uniform, so attention returns v itself."""
        return self.out_proj(self.v_proj(vec))

    def forward(self, x, kv=None, mask=None, *, cache=None, kv_pair=None, generator=None):
        q = self._split(self.q_proj(x))
        k, v = kv_pair if kv_pair is not None else self.kv(x if kv is None else kv)
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

    def cross_kv(self, encoder_hidden):
        return self.encoder_attn.kv(encoder_hidden)

    def forward(self, x, encoder_hidden, self_mask, cross_mask=None, *, cache=None,
                cross_kv=None, cross_const=None, generator=None):
        def drop(t):
            return dropout(t, self.dropout, generator)

        a = self.self_attn(x, mask=self_mask, cache=cache, generator=generator)
        x = self.self_attn_layer_norm(x + drop(a))
        if cross_const is not None:
            a = cross_const[:, None, :]
        else:
            a = self.encoder_attn(x, kv=encoder_hidden, mask=cross_mask, kv_pair=cross_kv,
                                  generator=generator)
        x = self.encoder_attn_layer_norm(x + drop(a))
        f = self.fc2(drop(F.gelu(self.fc1(x))))  # BART's exact (erf) GELU
        return self.final_layer_norm(x + drop(f))


class BartDecoderModel(nn.Module):
    """Decoder + lm_head on the shared embedding.  Full-sequence mode:
    ``caches=None``, causal mask.  Incremental mode: 1-token inputs with
    explicit ``positions``, ``caches`` from :meth:`init_cache`, and either
    the encoder states (optionally ``cross_kvs`` from :meth:`cross_attn_kv`)
    or ``cross_consts`` from :meth:`cross_attn_const` (tiled pseudo-encoder
    only).  With a ``generator`` (train mode) the full-sequence mode applies
    the JAX module's dropouts."""

    def __init__(self, cfg: BartConfig):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Parameter(
            torch.empty(cfg.max_position_embeddings + cfg.position_offset, cfg.d_model)
        )
        self.layernorm_embedding = nn.LayerNorm(cfg.d_model, eps=1e-5)
        for li in range(cfg.decoder_layers):
            self.add_module(f"layer{li}", _BartDecoderLayer(cfg))
        if cfg.tie_word_embeddings:
            self.final_logits_bias = nn.Parameter(torch.empty(cfg.vocab_size))

    def layers(self):
        return [getattr(self, f"layer{li}") for li in range(self.cfg.decoder_layers)]

    def cross_attn_kv(self, encoder_hidden):
        """Per-layer (k, v) cross-attention projections of fixed encoder
        states ``(B, S, d)``: compute once per generate call."""
        return [layer.cross_kv(encoder_hidden) for layer in self.layers()]

    def cross_attn_const(self, enc_vec):
        """Per-layer constant cross-attention outputs for a TILED
        pseudo-encoder built from ``enc_vec`` (B, d)."""
        return [layer.encoder_attn.uniform_const(enc_vec) for layer in self.layers()]

    def forward(self, decoder_input_ids, encoder_hidden_states=None,
                encoder_attention_mask=None, *, positions=None, caches=None,
                cross_kvs=None, cross_consts=None, generator=None, return_hidden=False):
        cfg = self.cfg
        b, l = decoder_input_ids.shape
        if encoder_hidden_states is None and cross_kvs is None and cross_consts is None:
            raise ValueError("need encoder_hidden_states, cross_kvs or cross_consts")
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
                cross_kv=None if cross_kvs is None else cross_kvs[li],
                cross_const=None if cross_consts is None else cross_consts[li],
                generator=generator,
            )
        logits = F.linear(x, self.shared.weight)
        if cfg.tie_word_embeddings:
            logits = logits + self.final_logits_bias
        return (logits, x) if return_hidden else logits

    def init_cache(self, batch: int, max_length: int, dtype=torch.float32, device=None):
        hd = self.cfg.d_model // self.cfg.num_heads
        shape = (batch, self.cfg.num_heads, max_length, hd)
        return [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device), "index": 0}
            for _ in range(self.cfg.decoder_layers)
        ]


def cross_entropy_loss(logits, labels, *, label_smoothing: float = 0.0):
    """Token-level CE with a ``-100`` ignore index (HF semantics: the mean
    over non-ignored tokens, divided by ``max(n_valid, 1)``), on float32
    log-probabilities, with optional label smoothing.  Returns
    ``(loss, n_valid)``.  Under data parallelism ``n_valid`` is the count
    over every rank's rows, so ``loss`` is this rank's share of the global
    batch's mean (``parallel.data_parallel``)."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(valid, nll, 0.0)
    n_valid = data_parallel.sum_over_ranks(valid.sum())
    return nll.sum() / n_valid.clamp_min(1), n_valid
