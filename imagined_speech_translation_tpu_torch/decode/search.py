"""Greedy and beam search with HF ``generate`` semantics, static trip count.

Port of ``imagined_speech_translation_tpu.decode.search`` (see its module
docstring for the HF beam bookkeeping it reproduces, and
``tests/test_bart_parity.py`` / ``tests/test_beam_fuzz.py`` for the pins).
The model is ``step_fn(tokens, positions, caches) -> logits`` over
``(batch*beams, 1)`` token slabs; ``caches`` is a list of per-layer dicts that
the step updates in place and that beam reordering gathers by parent.

Every top-k breaks ties by the lowest index, as ``lax.top_k`` does:
``_top_k`` takes k argmax passes (``torch.argmax`` returns the first maximum),
never ``torch.topk``, whose tie order is unspecified.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

NEG_INF = -1.0e9  # HF's magic constant


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    max_length: int = 16
    min_length: int = 4
    num_beams: int = 3
    length_penalty: float = 1.0
    early_stopping: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 104
    decoder_start_token_id: int = 102
    forced_bos_token_id: int | None = None
    forced_eos_token_id: int | None = None


def _apply_processors(logp: torch.Tensor, cur: int, p: DecodeParams) -> torch.Tensor:
    """HF logits processors on log-probs ``(..., V)``: MinLength, ForcedBOS,
    ForcedEOS (``cur`` = current length including the decoder start)."""
    if cur < p.min_length:
        logp = logp.clone()
        logp[..., p.eos_token_id] = NEG_INF
    for forced_id, at in ((p.forced_bos_token_id, 1), (p.forced_eos_token_id, p.max_length - 1)):
        if forced_id is not None and cur == at:
            logp = torch.full_like(logp, NEG_INF)
            logp[..., forced_id] = 0.0
    return logp


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of ``(B, N)``: descending values, ties by
    ascending index (``lax.top_k`` order)."""
    masked = x.clone()
    idxs = []
    for _ in range(k):
        i = masked.argmax(dim=-1, keepdim=True)
        idxs.append(i)
        masked.scatter_(1, i, float("-inf"))
    idx = torch.cat(idxs, dim=1)
    return x.gather(1, idx), idx


def _gather_beams(caches, parent: torch.Tensor, batch: int, k: int) -> None:
    """Reorder every cache tensor's ``(batch*k, ...)`` leading axis by per-row
    parent beam indices ``(batch, k)``, in place in the cache dicts."""
    flat = (parent + torch.arange(batch, device=parent.device)[:, None] * k).reshape(-1)
    for cache in caches:
        for name, t in list(cache.items()):
            if torch.is_tensor(t) and t.dim() > 0:
                cache[name] = t.index_select(0, flat)


def greedy_search(step_fn: Callable, caches, batch: int, params: DecodeParams,
                  device=None) -> torch.Tensor:
    """Argmax decoding; ``(B, max_length)`` token ids, pad after EOS."""
    p = params
    L = p.max_length
    tokens = torch.full((batch, L), p.pad_token_id, dtype=torch.long, device=device)
    tokens[:, 0] = p.decoder_start_token_id
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    for cur in range(1, L):
        pos = torch.full((batch, 1), cur - 1, dtype=torch.long, device=device)
        logits = step_fn(tokens[:, cur - 1 : cur], pos, caches)
        logp = _apply_processors(torch.log_softmax(logits[:, -1].float(), dim=-1), cur, p)
        nxt = logp.argmax(dim=-1)
        nxt = torch.where(finished, p.pad_token_id, nxt)
        tokens[:, cur] = nxt
        finished = finished | (nxt == p.eos_token_id)
    return tokens


def beam_search(step_fn: Callable, caches, batch: int, params: DecodeParams,
                device=None) -> torch.Tensor:
    """HF-semantics beam search; best hypothesis per row ``(B, max_length)``.
    ``caches`` must already have a ``batch*num_beams`` leading dim."""
    p = params
    K, L = p.num_beams, p.max_length
    BK = batch * K
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.long, device=device)

    seqs = torch.full((batch, K, L), p.pad_token_id, **i64)
    seqs[:, :, 0] = p.decoder_start_token_id
    alive_scores = torch.full((batch, K), NEG_INF, **f32)
    alive_scores[:, 0] = 0.0  # HF init: only beam 0 live
    fin_seqs = torch.full((batch, K, L), p.pad_token_id, **i64)
    fin_scores = torch.full((batch, K), NEG_INF, **f32)
    fin_lens = torch.zeros((batch, K), **i64)
    fin_count = torch.zeros(batch, **i64)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    beam_ids = torch.arange(K, device=device)[None].expand(batch, K)

    for cur in range(1, L):
        last = seqs.reshape(BK, L)[:, cur - 1 : cur]
        pos = torch.full((BK, 1), cur - 1, **i64)
        logits = step_fn(last, pos, caches)
        V = logits.shape[-1]
        logp = _apply_processors(torch.log_softmax(logits[:, -1].float(), dim=-1), cur, p)
        total = alive_scores[..., None] + logp.reshape(batch, K, V)
        cand_scores, cand_idx = _top_k(total.reshape(batch, K * V), 2 * K)
        cand_beam = cand_idx // V
        cand_tok = cand_idx % V
        is_eos = cand_tok == p.eos_token_id

        # finished-hypothesis update: the top-K of (old hyps ∪ rank-<K
        # finishing candidates), old hyps first so ties keep the incumbent
        norm = float(cur) ** p.length_penalty
        is_final = cur == L - 1
        finishing = is_eos[:, :K] | is_final
        eligible = finishing & ~done[:, None]
        cand_fin_scores = torch.where(eligible, cand_scores[:, :K] / norm, NEG_INF)
        cand_fin_seqs = seqs.gather(1, cand_beam[:, :K, None].expand(batch, K, L))
        cand_fin_seqs[:, :, cur] = cand_tok[:, :K]
        union_scores = torch.cat([fin_scores, cand_fin_scores], dim=1)
        union_seqs = torch.cat([fin_seqs, cand_fin_seqs], dim=1)
        union_lens = torch.cat([fin_lens, torch.full((batch, K), cur + 1, **i64)], dim=1)
        fin_scores, keep = _top_k(union_scores, K)
        fin_seqs = union_seqs.gather(1, keep[:, :, None].expand(batch, K, L))
        fin_lens = union_lens.gather(1, keep)
        fin_count = torch.clamp(fin_count + eligible.sum(dim=1), max=K)

        # refill alive beams from the best non-finishing candidates
        alive_cand = cand_scores.masked_fill(is_eos | is_final, NEG_INF)
        new_scores, pick = _top_k(alive_cand, K)
        new_beam = cand_beam.gather(1, pick)
        new_tok = cand_tok.gather(1, pick)

        # frozen rows keep everything
        new_scores = torch.where(done[:, None], alive_scores, new_scores)
        parent = torch.where(done[:, None], beam_ids, new_beam)
        new_tok = torch.where(done[:, None], p.pad_token_id, new_tok)
        seqs = seqs.gather(1, parent[:, :, None].expand(batch, K, L))
        seqs[:, :, cur] = new_tok
        _gather_beams(caches, parent, batch, K)

        if p.early_stopping:
            newly_done = fin_count >= K
        else:
            cur_best = new_scores.max(dim=1).values / norm
            newly_done = (fin_count >= K) & (fin_scores.min(dim=1).values >= cur_best)
        done = done | newly_done
        alive_scores = new_scores

    # best hypothesis per row; HF fills with `pad_token_id or eos_token_id`
    # (pad 0 fills with EOS) up to the longest selected hypothesis, pad after
    best = fin_scores.argmax(dim=1, keepdim=True)
    out = fin_seqs.gather(1, best[:, :, None].expand(batch, 1, L))[:, 0]
    lens = fin_lens.gather(1, best)
    col = torch.arange(L, device=device)[None]
    fill = p.pad_token_id if p.pad_token_id != 0 else p.eos_token_id
    batch_max = lens.max()
    return torch.where(
        col >= lens,
        torch.where(col < batch_max, fill, p.pad_token_id),
        out,
    )
