"""Cross-region fusion encoder.

Port of ``imagined_speech_translation_tpu.models.brain_encoder``: the four
region encoders run as one batched :class:`RegionConvAttentionEncoder`, then
multi-scale convs over the region axis, region embeddings, fusion layers,
gated cross-region attention, region weighting and the final enhancer.  In
train mode every dropout of the JAX module draws from the ``generator``
passed to ``forward``.  With ``cfg.remat`` the region encoders' activations
are recomputed in the backward instead of kept, as the JAX module's
``nn.remat`` does (:func:`rematerialised`).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..config import BrainEncoderConfig
from ..ops import dropout
from .layers import MultiHeadAttention, RegionConvAttentionEncoder, gelu


class _FusionLayer(nn.Module):
    """Pre-norm transformer encoder layer over the region axis."""

    def __init__(self, dim: int, num_heads: int, ffn_mult: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads, dropout=dropout)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn_fc1 = nn.Linear(dim, dim * ffn_mult)
        self.ffn_fc2 = nn.Linear(dim * ffn_mult, dim)

    def forward(self, x, generator=None):
        rate = self.dropout
        x = x + dropout(self.attn(self.norm1(x), generator=generator), rate, generator)
        f = dropout(gelu(self.ffn_fc1(self.norm2(x))), rate, generator)
        return x + dropout(self.ffn_fc2(f), rate, generator)


class _Enhancer(nn.Module):
    """Linear(h->2h) GELU Dropout Linear(2h->h) LayerNorm."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.fc1 = nn.Linear(dim, dim * 2)
        self.fc2 = nn.Linear(dim * 2, dim)
        self.ln = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, generator=None):
        return self.ln(self.fc2(dropout(gelu(self.fc1(x)), self.dropout, generator)))


@contextlib.contextmanager
def _buffers_kept(module: nn.Module):
    """Restores ``module``'s buffers on exit (BatchNorm's running statistics)."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in saved:
                b.copy_(s)


def rematerialised(module: nn.Module, x, generator=None):
    """``module(x, generator)`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of kept.

    The recompute runs with the parameter tensors of the first run (those
    ``functional_call`` put in place, such as a bfloat16 copy), draws its
    dropout seeds from a generator set to the state the first run started
    from, so it replays the same masks, and leaves the running statistics as
    the first run left them.  Afterwards ``generator`` stands where it would
    without the checkpoint: gradients, masks and generator position are
    those of ``module(x, generator)``."""
    names, tensors = zip(*module.named_parameters())
    state = None if generator is None else generator.get_state()
    runs = []

    def run(x, *params):
        gen = None
        if state is not None:
            gen = torch.Generator(generator.device)
            gen.set_state(state)
            runs.append(gen)
        return functional_call(module, dict(zip(names, params)), (x, gen))

    out = checkpoint(run, x, *tensors, use_reentrant=False,
                     context_fn=lambda: (contextlib.nullcontext(), _buffers_kept(module)))
    if generator is not None:
        generator.set_state(runs[0].get_state())
    return out


class BrainRegionEncoder(nn.Module):
    """Stacked-region EEG ``(B, R, C, T)`` -> fused ``(B, hidden_dim)`` feature."""

    def __init__(self, cfg: BrainEncoderConfig, *, in_channels: int, n_timepoints: int,
                 n_regions: int = 4):
        super().__init__()
        self.cfg, self.n_regions = cfg, n_regions
        h = cfg.hidden_dim
        self.region_encoders = RegionConvAttentionEncoder(
            cfg.region_encoder, h, n_regions=n_regions, in_channels=in_channels,
            n_timepoints=n_timepoints,
        )
        for k in cfg.multi_scale_kernels:
            self.add_module(f"temporal_scale_k{k}", nn.Conv1d(h, h, k, padding=k // 2))
        self.diversity_projection_fc1 = nn.Linear(h * len(cfg.multi_scale_kernels), h * 2)
        self.diversity_projection_fc2 = nn.Linear(h * 2, h)
        self.diversity_projection_ln = nn.LayerNorm(h, eps=1e-5)
        self.region_embeddings = nn.Parameter(torch.empty(n_regions, h))
        self.feature_enhancer = _Enhancer(h)
        if not cfg.disable_cross_region_attn:
            for i in range(cfg.fusion_layers):
                self.add_module(f"fusion_layer{i}", _FusionLayer(h, cfg.fusion_heads))
            self.cross_region_attention = MultiHeadAttention(h, cfg.cross_region_heads,
                                                             dropout=0.1)
        if not cfg.uniform_region_weight:
            self.region_importance = nn.Parameter(torch.empty(n_regions))
            self.region_gate_fc1 = nn.Linear(h, h // 2)
            self.region_gate_fc2 = nn.Linear(h // 2, n_regions)

    def forward(self, eeg, channel_mask=None, generator=None):
        """``eeg``: (B, R, C, T); ``channel_mask``: (R, C) bool;
        ``generator``: the dropout stream in train mode, ``None`` in eval."""
        cfg = self.cfg
        if channel_mask is not None:
            mask = torch.as_tensor(channel_mask, device=eeg.device)
            eeg = torch.where(mask[None, :, :, None], eeg, 0.0)

        if cfg.remat and torch.is_grad_enabled():
            feats = rematerialised(self.region_encoders, eeg, generator)
        else:
            feats = self.region_encoders(eeg, generator)
        feats = feats.transpose(0, 1)  # (B, R, h)

        # multi-scale convs over the region axis: (B, h, R) channel-first
        fr = feats.transpose(1, 2)
        ms = torch.cat(
            [gelu(getattr(self, f"temporal_scale_k{k}")(fr)).mean(dim=-1)
             for k in cfg.multi_scale_kernels],
            dim=-1,
        )
        y = dropout(gelu(self.diversity_projection_fc1(ms)), 0.1, generator)
        y = self.diversity_projection_ln(self.diversity_projection_fc2(y))
        x = feats + cfg.multi_scale_weight * y[:, None, :]
        x = x + cfg.region_embed_weight * self.region_embeddings[None]

        if not cfg.disable_cross_region_attn:
            for i in range(cfg.fusion_layers):
                x = getattr(self, f"fusion_layer{i}")(x, generator)
            cross = self.cross_region_attention(x, generator=generator)
            gate = torch.sigmoid(self.feature_enhancer(x.mean(dim=1), generator))
            x = x + gate[:, None, :] * cross

        if cfg.uniform_region_weight:
            fused = x.mean(dim=1)
        else:
            g = dropout(gelu(self.region_gate_fc1(x.mean(dim=1))), 0.1, generator)
            dynamic = torch.sigmoid(self.region_gate_fc2(g))
            static = torch.softmax(self.region_importance, dim=0)
            combined = torch.softmax(
                cfg.static_weight_frac * static[None]
                + (1.0 - cfg.static_weight_frac) * dynamic,
                dim=1,
            )
            fused = (x * combined[..., None]).sum(dim=1)

        return fused + cfg.enhancer_weight * self.feature_enhancer(fused, generator)

    def region_weights(self) -> dict:
        """Static softmax region importance, for the evaluation log."""
        names = ("frontal", "temporal", "central", "parietal")
        if self.cfg.uniform_region_weight:
            return {"names": names, "softmax": [0.25] * 4, "has_dynamic": False}
        w = torch.softmax(self.region_importance.detach().float(), dim=0)
        return {"names": names, "softmax": w.tolist(), "has_dynamic": True}


def feature_diversity_stats(region_feats: torch.Tensor) -> dict:
    """Diversity monitoring on per-region features ``(B, R, h)``:
    diversity = 1 - mean off-diagonal cosine similarity (averaged over the
    batch)."""
    x = region_feats / (torch.linalg.vector_norm(region_feats, dim=-1, keepdim=True) + 1e-12)
    sim = torch.einsum("brh,bsh->brs", x, x).mean(dim=0)
    off = ~torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    return {"diversity_score": 1.0 - sim[off].mean(), "region_similarities": sim}
