"""Composite anti-collapse seq2seq loss and the adaptive weight scheduler.

Port of ``imagined_speech_translation_tpu.training.losses``:

* label-smoothed CE with a ``-100`` ignore mask;
* alignment: symmetric InfoNCE between projected EEG features and
  mask-pooled decoder states at temperature ``tau``;
* bag of words: BCE-with-logits from EEG features onto the multi-hot of the
  top-k vocabulary ids present in the labels;
* diversity: mean |off-diagonal cosine similarity| of the batch's EEG
  features;
* variance: ``mean(exp(-var))`` over feature dimensions;

the learnable heads (:class:`CompositeLossHeads`), the BoW vocabulary pick
and the host-side :class:`AdaptiveLossScheduler`, which is plain Python and
copied unchanged.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LossConfig


def label_smoothed_ce(logits, labels, *, label_smoothing: float = 0.0):
    """Mean CE over non-``-100`` tokens (HF semantics).  Returns
    ``(loss, n_valid)``."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        smooth = -logp.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    nll = torch.where(valid, nll, 0.0)
    n = valid.sum().clamp_min(1)
    return nll.sum() / n, valid.sum()


def _promoted(*ts):
    """``ts`` cast to their common dtype, as JAX promotes mixed operands
    (the bfloat16 EEG side meets the float32 pooled text side under mixed
    precision)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


class CompositeLossHeads(nn.Module):
    """Learnable heads of the composite loss: contrastive projections and the
    BoW classifier.  Each Dense computes in the promoted dtype of its input
    and weights, as flax's ``nn.Dense`` does."""

    def __init__(self, hidden_dim: int, bart_dim: int, bow_k: int, proj_dim: int = 256):
        super().__init__()
        self.eeg_proj = nn.Linear(hidden_dim, proj_dim)
        self.txt_proj = nn.Linear(bart_dim, proj_dim)
        self.bow_head = nn.Linear(hidden_dim, bow_k)

    def forward(self, eeg_feat, text_feat):
        def dense(layer, x):
            return F.linear(*_promoted(x, layer.weight, layer.bias))

        return (dense(self.eeg_proj, eeg_feat), dense(self.txt_proj, text_feat),
                dense(self.bow_head, eeg_feat))


def _info_nce(eeg_p, txt_p, tau: float):
    """Symmetric InfoNCE over the in-batch similarity matrix."""
    e = eeg_p / (torch.linalg.vector_norm(eeg_p, dim=-1, keepdim=True) + 1e-8)
    t = txt_p / (torch.linalg.vector_norm(txt_p, dim=-1, keepdim=True) + 1e-8)
    e, t = _promoted(e, t)
    sim = (e @ t.T).float() / tau
    diag = torch.arange(sim.shape[0], device=sim.device)
    loss_e2t = -F.log_softmax(sim, dim=-1)[diag, diag].mean()
    loss_t2e = -F.log_softmax(sim, dim=0)[diag, diag].mean()
    return 0.5 * (loss_e2t + loss_t2e)


def _bow_multi_hot(labels, bow_indices, vocab: int):
    """(B, L) labels -> (B, K) multi-hot of which bow tokens appear."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    present = torch.zeros((labels.shape[0], vocab), dtype=torch.float32, device=labels.device)
    present.scatter_add_(1, safe, valid.float())
    return present.clamp(0.0, 1.0)[:, bow_indices]


def _diversity_loss(feat):
    f = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-8)
    sim = (f @ f.T).float()
    b = sim.shape[0]
    off = sim * (1.0 - torch.eye(b, device=sim.device))
    return off.abs().sum() / max(b * (b - 1), 1)


def _variance_loss(feat):
    var = feat.float().var(dim=0, unbiased=False)
    return torch.exp(-var).mean()


def optax_sigmoid_bce(logits, targets):
    """Mean sigmoid binary cross-entropy (``optax.sigmoid_binary_cross_entropy``)."""
    logits = logits.float()
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def composite_loss(*, logits, labels, eeg_feat, decoder_hidden, decoder_mask, heads_apply,
                   bow_indices, weights: dict, cfg: LossConfig):
    """Total loss and per-component dict.  ``heads_apply(eeg_feat,
    text_feat)`` runs :class:`CompositeLossHeads`."""
    ce, _ = label_smoothed_ce(logits, labels, label_smoothing=cfg.label_smoothing)
    # mask-pooled decoder hidden (the text-side view)
    m = decoder_mask.float()[..., None]
    text_feat = (decoder_hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    eeg_p, txt_p, bow_logits = heads_apply(eeg_feat, text_feat)

    align = _info_nce(eeg_p, txt_p, cfg.contrastive_tau)
    bow = optax_sigmoid_bce(bow_logits, _bow_multi_hot(labels, bow_indices, logits.shape[-1]))
    div = _diversity_loss(eeg_feat)
    var = _variance_loss(eeg_feat)
    total = (weights["ce"] * ce + weights["align"] * align + weights["bow"] * bow
             + weights["div"] * div + weights["var"] * var)
    return total, {"loss_ce": ce, "loss_align": align, "loss_bow": bow, "loss_div": div,
                   "loss_var": var}


# ---------------------------------------------------------------------------
# BoW vocabulary selection
# ---------------------------------------------------------------------------


def get_top_k_vocab_indices(tokenizer, k: int, texts=None) -> list[int]:
    """Top-k content-token ids for the BoW loss: by corpus frequency with
    ``texts``, else the first k non-special ids."""
    special = getattr(tokenizer, "special_ids", set())
    if texts:
        counts: Counter = Counter()
        for t in texts:
            ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(t))
            counts.update(i for i in ids if i not in special)
        ranked = [i for i, _ in counts.most_common(k)]
        if len(ranked) >= k:
            return ranked[:k]
        pool = [i for i in range(tokenizer.vocab_size)
                if i not in special and i not in set(ranked)]
        return ranked + pool[: k - len(ranked)]
    pool = [i for i in range(tokenizer.vocab_size) if i not in special]
    return pool[:k]


# ---------------------------------------------------------------------------
# Adaptive weight scheduler (host-side)
# ---------------------------------------------------------------------------


@dataclass
class AdaptiveLossScheduler:
    """Nudges composite-loss weights from validation diversity (thresholds
    0.3/0.8, loss-history window 10, adaptation_rate 0.01).

    Low diversity -> boost the anti-collapse terms and damp CE; high
    diversity -> relax everything back toward the initial weights."""

    cfg: LossConfig
    weights: dict[str, float] = field(default_factory=dict)
    history: list[float] = field(default_factory=list)
    comp_history: list[dict] = field(default_factory=list)

    MIN_WEIGHTS = {"ce": 0.2, "align": 0.1, "bow": 0.05, "div": 0.05, "var": 0.01}
    MAX_WEIGHTS = {"ce": 2.0, "align": 3.0, "bow": 2.0, "div": 4.5, "var": 2.0}

    def __post_init__(self):
        if not self.weights:
            self.weights = self.initial_weights()

    def initial_weights(self) -> dict[str, float]:
        c = self.cfg
        return {
            "ce": c.w_ce, "align": c.w_align, "bow": c.w_bow,
            "div": c.w_div, "var": c.w_var,
        }

    def _stagnant(self, comp: str) -> bool:
        """True when the component's recent validation loss stopped improving
        over the history window (recent-3 mean >= earlier-window mean)."""
        vals = [
            h[f"loss_{comp}"] for h in self.comp_history
            if f"loss_{comp}" in h
        ]
        if len(vals) < 4:
            return False
        recent = sum(vals[-3:]) / 3.0
        earlier = sum(vals[:-3]) / len(vals[:-3])
        return recent >= earlier

    def update(self, loss_components: dict, diversity: float) -> dict[str, float]:
        self.history.append(float(diversity))
        self.comp_history.append(
            {k: float(v) for k, v in (loss_components or {}).items()}
        )
        for h in (self.history, self.comp_history):
            while len(h) > self.cfg.history_window:
                h.pop(0)
        recent = sum(self.history[-3:]) / min(len(self.history), 3)
        rate = self.cfg.adaptation_rate
        init = self.initial_weights()
        if recent < self.cfg.diversity_low:
            # collapse pressure: boost anti-collapse terms, damp CE
            boost = 1.0 + rate * 10.0
            for k in ("align", "bow", "div", "var"):
                self.weights[k] *= boost
            self.weights["ce"] *= 1.0 - rate
        elif recent > self.cfg.diversity_high:
            # relax toward initial
            for k in self.weights:
                self.weights[k] += rate * (init[k] - self.weights[k])
        else:
            # mid-band: an anti-collapse term whose validation loss stagnated
            # gets more weight, one that is still improving is left alone
            for k in ("align", "bow", "div", "var"):
                if self._stagnant(k):
                    self.weights[k] *= 1.0 + rate * 5.0
        for k in self.weights:
            self.weights[k] = float(
                min(max(self.weights[k], self.MIN_WEIGHTS[k]), self.MAX_WEIGHTS[k])
            )
        return dict(self.weights)

    def get_weights(self) -> dict[str, float]:
        return dict(self.weights)

    def state_dict(self) -> dict:
        return {
            "weights": dict(self.weights),
            "history": list(self.history),
            "comp_history": [dict(h) for h in self.comp_history],
        }

    def load_state_dict(self, d: dict) -> None:
        self.weights = dict(d.get("weights", self.weights))
        self.history = list(d.get("history", []))
        self.comp_history = [dict(h) for h in d.get("comp_history", [])]
