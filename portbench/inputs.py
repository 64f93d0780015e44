"""What the benchmark makes from ``--seed``: the weights, the EEG windows,
the training batches, the vocabulary and the montage.  Everything random is
drawn on the run's device from ``torch.Generator`` streams seeded from the
run's seed, in a few large calls; the same seed gives the same inputs on
the same kind of device."""

from __future__ import annotations

import math

import numpy as np
import torch

#: the region electrodes (the paper's Table 1: frontal 16, temporal 9,
#: central 11, parietal 12), scattered over the montage
REGION_ELECTRODES = (
    ("FC5", "F5", "F7", "F3", "FC1", "F1", "AF3", "Fz", "FC2", "F2", "AF4", "Fp2", "F4", "F6",
     "F8", "FC6"),
    ("T9", "FT9", "T7", "TP7", "FT8", "T10", "FT10", "T8", "TP8"),
    ("C5", "C3", "FC3", "C1", "CP1", "Cz", "CP2", "C2", "C4", "FC4", "C6"),
    ("P7", "P5", "CP3", "P3", "PO3", "PO1", "PO2", "P4", "PO4", "P6", "CP4", "P8"),
)
#: tokens the decoder never serves as text (the tokenizer skips them)
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
EMBEDDINGS = ("shared.weight", "embed_positions", "cls_token", "temporal_tokens", "pos_emb",
              "region_embeddings")
NORM_MARKS = ("norm", "_ln", ".ln.", "_bn.", ".bn.", "layernorm")


def stream(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of the run's seed."""
    mixed = (int(seed) * 1_000_003 + purpose * 7_919) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def vocab(size: int) -> list[str]:
    """A BERT-layout vocabulary of ``size`` tokens: ``[PAD]``, 99 unused
    tokens, the other specials, then single CJK characters and word
    pieces."""
    head = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + list(SPECIALS[1:])
    rest = [chr(0x4E00 + i) if i < 0x5200 else f"w{i}" for i in range(size - len(head))]
    return head + rest


def montage(n_channels: int = 125) -> list[str]:
    """``n_channels`` labels with the 48 region electrodes at fixed places
    among auxiliary channels."""
    labels = [f"AUX{i}" for i in range(n_channels)]
    mapped = [ch for region in REGION_ELECTRODES for ch in region]
    slots = sorted(np.random.default_rng(0).choice(n_channels, size=len(mapped),
                                                   replace=False))
    for slot, ch in zip(slots, mapped):
        labels[slot] = ch
    return labels


def region_gather(labels: list[str], max_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """``(R, C)`` montage indices of each region's electrodes (0 where
    padded) and the mask of real ones."""
    index = {ch: i for i, ch in enumerate(labels)}
    gather = np.zeros((len(REGION_ELECTRODES), max_channels), np.int64)
    mask = np.zeros((len(REGION_ELECTRODES), max_channels), bool)
    for r, region in enumerate(REGION_ELECTRODES):
        idx = [index[ch] for ch in region if ch in index]
        gather[r, : len(idx)] = idx
        mask[r, : len(idx)] = True
    return gather, mask


def _init(name: str, shape, flat: torch.Tensor) -> torch.Tensor:
    """The weight ``name`` from standard normals ``flat`` (in place): a
    fan-in scaled normal for products, 0.02 for embeddings and tokens, 1 +
    0.1 N for norm scales, 0.02 N for biases, BatchNorm statistics around
    0 and 1."""
    leaf = name.rsplit(".", 1)[-1]
    t = flat.view(shape)
    if name.endswith("running_mean"):
        return t.mul_(0.1)
    if name.endswith("running_var"):
        return t.mul_(0.2).exp_()
    if name.endswith("region_importance"):
        return t.mul_(0.5)
    if any(name.endswith(e) for e in EMBEDDINGS):
        return t.mul_(0.02)
    if leaf == "bias" or leaf == "final_logits_bias":
        return t.mul_(0.02)
    if any(m in name for m in NORM_MARKS):
        return t.mul_(0.1).add_(1.0)
    stacked = "region_encoders." in name and t.dim() >= 3
    fan_in = math.prod(shape[2:] if stacked else shape[1:])
    return t.mul_(fan_in**-0.5)


def weights(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights ``{name: tensor}`` for ``spec`` (``(name, shape)``
    pairs, the program's parameters and buffers), drawn in one call."""
    spec = [(n, tuple(s)) for n, s in spec]
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=stream(seed, 1, device), device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        out[name] = _init(name, shape, flat[at: at + n])
        at += n
    return out


def windows(seed: int, n: int, n_channels: int, length: int, device, *,
            sample_rate: float = 500.0, purpose: int = 2) -> torch.Tensor:
    """``(n, n_channels, length)`` float32 raw EEG windows, each different:
    white noise at a per-channel amplitude, three rhythms of 2-30 Hz at
    per-channel gains, and a per-channel offset."""
    g = stream(seed, purpose, device)
    x = torch.randn(n, n_channels, length, generator=g, device=device)
    amp = torch.randn(n, n_channels, 1, generator=g, device=device).mul_(0.5).exp_()
    x.mul_(amp)
    freq = torch.rand(n, 1, 3, generator=g, device=device) * 28.0 + 2.0
    phase = torch.rand(n, 1, 3, generator=g, device=device) * (2 * math.pi)
    gain = torch.randn(n, n_channels, 3, generator=g, device=device) * 2.0
    t = torch.arange(length, device=device, dtype=torch.float32) / sample_rate
    for k in range(3):
        wave = torch.sin(2 * math.pi * freq[..., k, None] * t + phase[..., k, None])
        x.add_(gain[..., k, None] * wave)
    x.add_(torch.randn(n, n_channels, 1, generator=g, device=device) * 5.0)
    return x


def train_batches(seed: int, n_steps: int, accum: int, batch: int, mask: np.ndarray,
                  length: int, label_length: int, vocab_size: int, device,
                  first_id: int = 105) -> list[dict[str, torch.Tensor]]:
    """``n_steps`` distinct window batches ``(accum, batch, ...)`` on the
    region layout: EEG on the real channels, decoder inputs and next-token
    labels over the content ids; in each micro-batch the second window's
    labels end after 12 tokens (-100 beyond, attention mask 0)."""
    r, c = mask.shape
    m = torch.as_tensor(mask, device=device)
    raw = windows(seed, n_steps * accum * batch, r * c, length, device, purpose=3)
    eeg = raw.view(n_steps, accum, batch, r, c, length) * m[:, :, None]
    g = stream(seed, 4, device)
    ids = torch.randint(first_id, vocab_size, (n_steps, accum, batch, label_length + 1),
                        generator=g, device=device)
    out = []
    for s in range(n_steps):
        labels = ids[s, ..., 1:].clone()
        attn = torch.ones(accum, batch, label_length, dtype=torch.int32, device=device)
        if batch > 1:
            attn[:, 1, 12:] = 0
            labels[:, 1, 12:] = -100
        out.append(dict(eeg=eeg[s].contiguous(), decoder_input_ids=ids[s, ..., :-1].contiguous(),
                        labels=labels, attention_mask=attn, channel_mask=m))
    return out
