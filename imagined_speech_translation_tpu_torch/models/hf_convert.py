"""HF -> port weight conversion for the BART decoder.

Port of ``imagined_speech_translation_tpu.models.hf_convert``.  A
``BartForConditionalGeneration`` ``state_dict`` (the reference fine-tunes
``fnlp/bart-base-chinese``) becomes a ``state_dict`` of the port's
``BartDecoderModel``: the shared embedding, the learned positions,
``layernorm_embedding``, the decoder layers and ``final_logits_bias``.  The
BART text encoder is bypassed by the pseudo-encoder sequence and is dropped.
HF's ``Linear`` weights are ``(out, in)``, as the port's, so nothing is
transposed; only the names change (``decoder.layers.{i}`` -> ``layer{i}``).

``resize_embedding`` is HF's ``resize_token_embeddings``: truncate, or
append rows set to the mean of the existing rows.
"""

from __future__ import annotations

import torch

# a decoder layer's tensors, under the same names in HF and in the port
LAYER_PARTS = (
    [f"{a}.{p}.{w}" for a in ("self_attn", "encoder_attn")
     for p in ("q_proj", "k_proj", "v_proj", "out_proj") for w in ("weight", "bias")]
    + [f"{n}.{w}" for n in ("self_attn_layer_norm", "encoder_attn_layer_norm", "fc1", "fc2",
                            "final_layer_norm") for w in ("weight", "bias")]
)


def convert_hf_bart_state_dict(state_dict, *, decoder_layers: int,
                               vocab_size: int | None = None) -> dict[str, torch.Tensor]:
    """``state_dict``: HF parameter names -> tensors (or arrays).  Returns the
    ``state_dict`` of a ``BartDecoderModel`` with ``decoder_layers`` layers
    and the tied head, whose vocabulary is the checkpoint's, or
    ``vocab_size`` when given."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    # strip the leading "model." of BartForConditionalGeneration
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}

    embedding = sd.get("shared.weight", sd.get("decoder.embed_tokens.weight"))
    if embedding is None:
        raise KeyError("no shared/decoder embedding in state dict")
    if vocab_size is not None and embedding.shape[0] != vocab_size:
        embedding = resize_embedding(embedding, vocab_size)

    out = {
        "shared.weight": embedding,
        "embed_positions": sd["decoder.embed_positions.weight"],
        "layernorm_embedding.weight": sd["decoder.layernorm_embedding.weight"],
        "layernorm_embedding.bias": sd["decoder.layernorm_embedding.bias"],
    }
    for i in range(decoder_layers):
        for part in LAYER_PARTS:
            out[f"layer{i}.{part}"] = sd[f"decoder.layers.{i}.{part}"]

    n = embedding.shape[0]
    bias = sd.get("final_logits_bias")
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32)
    else:
        bias = bias.reshape(-1)  # HF keeps it as (1, V)
        if bias.shape[0] != n:
            cut = torch.zeros(n, dtype=bias.dtype)
            cut[: min(bias.shape[0], n)] = bias[:n]
            bias = cut
    out["final_logits_bias"] = bias
    return out


def resize_embedding(embedding: torch.Tensor, new_size: int) -> torch.Tensor:
    """HF ``resize_token_embeddings`` semantics: truncate, or append rows set
    to the mean of the existing rows."""
    old = embedding.shape[0]
    if new_size == old:
        return embedding
    if new_size < old:
        return embedding[:new_size]
    mean = embedding.mean(dim=0, keepdim=True)
    return torch.cat([embedding, mean.expand(new_size - old, -1)], dim=0)
