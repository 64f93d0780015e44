"""Operations and bytes of the work, counted from the configuration's
shapes, never from what a kernel launches: the count stays the same
whatever implements the work.

An operation is a multiply or an add of a product: a matrix product of
``(m, k) x (k, n)`` counts ``2 m k n`` and a convolution ``2`` times its
outputs times its kernel's taps over its input channels, as
``torch.utils.flop_counter`` counts them.  Counted: every convolution of
the stem (the depthwise and pointwise stage and the 1x1 residuals
included), every product of the token attention (the q/k/v/out
projections, the scores and the weighted values of each layer and of the
cross-scale attention), the gated FFNs, squeeze-excite, the pooled
projection and the diversity head, the multi-scale convolutions over the
region axis, the fusion layers, the cross-region attention, the enhancer
and the region gate, ``eeg_to_bart``, and the decoder over its positions
(self-attention, the cross-attention as ``out_proj(v_proj(feature))``, the
FFN and the vocabulary head).  Left out: elementwise work, norms, softmax,
the IIR (counted as bytes), and AdamW (elementwise; bytes).
"""

from __future__ import annotations


def _mm(m, k, n):
    return 2 * m * k * n


def encoder_flops(cfg: dict, batch: int) -> int:
    """The EEG encoder of ``batch`` windows up to ``eeg_to_bart``."""
    m, be = cfg["model"], cfg["model"]["brain_encoder"]
    re, h = be["region_encoder"], be["hidden_dim"]
    r, t = len(m["region_channel_counts"]), cfg["data"]["n_timepoints"]
    b = batch
    total, c_in = 0, m["max_region_channels"]
    for i, (feats, k) in enumerate(zip(re["conv_channels"], re["conv_kernels"])):
        if i == re["depthwise_stage"]:
            total += 2 * b * r * c_in * t * k + _mm(b * r * t, c_in, feats)
        else:
            total += 2 * b * r * feats * t * c_in * k
            if c_in != feats:
                total += _mm(b * r * t, c_in, feats)
        c_in = feats
    red = max(1, c_in // re["se_reduction"])
    total += 2 * _mm(r * b, c_in, red)
    # stem tokens into the attention width
    total += _mm(r * b * t, c_in, 2 * h) + _mm(r * b * t, 2 * h, h) + _mm(r * b * t, h, h)
    s = t + 1 + re["num_temporal_tokens"]
    attention = 4 * _mm(r * b * s, h, h) + 2 * _mm(r * b * s, s, h)
    for i in range(re["num_attn_layers"]):
        hidden = h * (4 if i == 0 else 2)
        total += attention + 2 * _mm(r * b * s, h, hidden) + _mm(r * b * s, hidden, h)
        if i > 0:
            total += attention  # the cross-scale attention
    total += 3 * _mm(r * b, h, h) + _mm(r * b, 3 * h, 2 * h) + _mm(r * b, 2 * h, h)
    total += _mm(r * b, h, h)  # diversity head
    # fusion over the region axis
    for k in be["multi_scale_kernels"]:
        total += 2 * b * h * r * h * k
    nk = len(be["multi_scale_kernels"])
    total += _mm(b, nk * h, 2 * h) + _mm(b, 2 * h, h)
    fusion_attention = 4 * _mm(b * r, h, h) + 2 * _mm(b * r, r, h)
    if not be["disable_cross_region_attn"]:
        total += be["fusion_layers"] * (fusion_attention + 2 * _mm(b * r, h, 4 * h))
        total += fusion_attention + _mm(b, h, 2 * h) + _mm(b, 2 * h, h)
    if not be["uniform_region_weight"]:
        total += _mm(b, h, h // 2) + _mm(b, h // 2, r)
    total += _mm(b, h, 2 * h) + _mm(b, 2 * h, h)  # the enhancer of the fused feature
    total += _mm(b, h, m["bart"]["d_model"])  # eeg_to_bart
    return total


def decoder_flops(cfg: dict, rows: int, length: int) -> int:
    """The decoder teacher-forced over ``length`` positions of ``rows``
    sequences (full ``length x length`` scores), with the vocabulary head."""
    bart = cfg["model"]["bart"]
    d, f, v = bart["d_model"], bart["ffn_dim"], bart["vocab_size"]
    n = rows * length
    layer = (4 * _mm(n, d, d) + 2 * _mm(rows * length, length, d)
             + 2 * _mm(rows, d, d) + 2 * _mm(n, d, f))
    return bart["decoder_layers"] * layer + _mm(n, d, v)


def serve_window_flops(cfg: dict, beams: int, length: int) -> int:
    """One served window: its encoder, then ``length`` decoded positions on
    each of ``beams`` beams."""
    return encoder_flops(cfg, 1) + decoder_flops(cfg, beams, length)


def loss_heads_flops(cfg: dict, batch: int, bow_k: int, proj_dim: int = 256) -> int:
    """The composite loss's heads and batch similarity matrices."""
    h, d = cfg["model"]["hidden_dim"], cfg["model"]["bart"]["d_model"]
    return (_mm(batch, h, proj_dim) + _mm(batch, d, proj_dim) + _mm(batch, h, bow_k)
            + _mm(batch, proj_dim, batch) + _mm(batch, h, batch))


def train_forward_flops(cfg: dict, batch: int, length: int, bow_k: int) -> int:
    """One micro-batch's forward: encoder, teacher-forced decoder, loss heads."""
    return (encoder_flops(cfg, batch) + decoder_flops(cfg, batch, length)
            + loss_heads_flops(cfg, batch, bow_k))


def train_step_flops(cfg: dict, accum: int, batch: int, length: int, bow_k: int) -> int:
    """One optimizer step: every micro-batch's forward, and its backward at
    twice the forward's products (the gradient of each product's two
    operands)."""
    return 3 * accum * train_forward_flops(cfg, batch, length, bow_k)


# -- the flash kernels' calls ------------------------------------------------

def flash_calls(cfg: dict, batch: int) -> list[tuple[int, int, int]]:
    """``(batch*heads, tokens, head_dim)`` of each long unmasked attention of
    one encoder pass over ``batch`` windows: the token attention of every
    layer and the cross-scale attention after every layer but the first."""
    m = cfg["model"]
    re, h = m["brain_encoder"]["region_encoder"], m["brain_encoder"]["hidden_dim"]
    r = len(m["region_channel_counts"])
    s = cfg["data"]["n_timepoints"] + 1 + re["num_temporal_tokens"]
    calls = [(r * batch * heads, s, h // heads) for heads in re["attn_heads"]]
    cross = re["attn_heads"][0] // 2
    calls += [(r * batch * cross, s, h // cross)] * (re["num_attn_layers"] - 1)
    return calls


def flash_forward(bh: int, s: int, d: int, elem: int) -> tuple[int, int]:
    """Operations and bytes of one forward: ``QK^T`` and ``PV``; Q, K and V
    read once, O written once."""
    return 4 * bh * s * s * d, 4 * bh * s * d * elem


def flash_backward(bh: int, s: int, d: int, elem: int) -> tuple[int, int]:
    """Operations and bytes of one backward: the scores again, ``dP = dO
    V^T``, ``dV = P^T dO``, ``dQ = dS K``, ``dK = dS^T Q``; Q, K, V, O, dO
    read once, dQ, dK, dV written once."""
    return 10 * bh * s * s * d, 8 * bh * s * d * elem


def least_seconds(flops: int, nbytes: int, peak_flops: float, peak_bytes: float) -> float:
    """The roofline: the larger of the compute and the memory bound."""
    return max(flops / peak_flops, nbytes / peak_bytes)


def iir_bytes(rows: int, length: int) -> int:
    """The IIR over ``rows`` float32 series: each sample read once and
    written once."""
    return 2 * rows * length * 4
