"""The comparisons that decide ``correct``.

Serving.  Beam search keeps, at every step, the best ``2K`` continuations of
its ``K`` beams by summed log-probability and refills the beams from the
best ``K`` of them; the end-of-sequence token is barred while the text is
shorter than the minimum length.  So every token of a served text is among
the ``K`` most likely tokens after its own prefix, end-of-sequence aside.
The reference runs the served prefix teacher-forced and reads, at every
position, by how much the served token's log-probability lies below the
reference's ``K``-th best: ``beam_gap`` is the widest such gap over the
sampled texts, in nats.  A sound program in a lower precision than float32
reaches a small positive gap where rounding reorders the tokens near the
``K``-th place; a wrong token or a zeroed encoder projection reach far more
(``portbench/limits``).  A text handed to the wrong window reaches more only
as far as the random weights tell the windows apart: on some seeds every
neighbour's token lies in the reference's top ``K`` too.

The control is the reference itself in float8 (``Precision(fp8=True)``) in
the program's place: at every position of the same texts it serves the
token it puts ``K``-th, and ``beam_gap`` reads that token's gap.

Training.  :mod:`.train` follows the program's first three optimizer steps
and the judge compares each step's loss components, the first step's
clipped gradient by leaf, and the parameters' change over the three steps by
leaf: the worst leaf's gap and the median leaf's (:func:`leaf_gap`).
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend import preprocess
from .model import Precision, RefModel, exact_float32


def serve_logprobs(model: RefModel, stacked: torch.Tensor, mask: torch.Tensor,
                   ids: torch.Tensor, eos: int) -> torch.Tensor:
    """Log-probabilities ``(N, L-1, V)`` of the tokens after each prefix of
    ``ids`` ``(N, L)`` (ids[:, 0] is the decoder start), the end-of-sequence
    token barred."""
    _, proj = model.encode(stacked, mask)
    logits = model.decode(ids[:, :-1], proj)
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp[..., eos] = float("-inf")
    return lp


@torch.no_grad()
@exact_float32()
def serve_gaps(cfg: dict, w: dict, raw: np.ndarray, ids: np.ndarray, gather: np.ndarray,
               mask: np.ndarray, *, eos: int, beams: int, device, control: bool = False,
               chunk: int = 8) -> np.ndarray:
    """``(N, L-1)``: at each served position, the gap (nats) of the served
    token below the float32 reference's ``beams``-th best; with
    ``control``, of the token the float8 reference puts ``beams``-th
    instead of the served one."""
    ref = RefModel(cfg, w)
    low = RefModel(cfg, w, Precision(fp8=True)) if control else None
    mask_t = torch.as_tensor(mask, device=device)
    stacked = preprocess(raw, cfg["frontend"], gather, mask).astype(np.float32)
    out = []
    for s in range(0, len(raw), chunk):
        x = torch.as_tensor(stacked[s: s + chunk], device=device)
        t = torch.as_tensor(ids[s: s + chunk], device=device, dtype=torch.long)
        lp = serve_logprobs(ref, x, mask_t, t, eos)
        kth = lp.topk(beams, dim=-1).values[..., -1]
        if low is None:
            tok = t[:, 1:]
        else:
            tok = serve_logprobs(low, x, mask_t, t, eos).topk(beams, dim=-1).indices[..., -1]
        gap = kth - lp.gather(-1, tok[..., None])[..., 0]
        out.append(gap.cpu().numpy())
        del lp
    return np.concatenate(out)


def leaf_gap(program: dict[str, float], reference: dict[str, float],
             keep) -> tuple[float, str, int, float]:
    """``|program - reference| / max(reference, median reference)`` over the
    norms by leaf, on the leaves ``keep(name)`` accepts; returns the worst
    leaf's gap, that leaf, the leaves compared and the median leaf's gap.
    The worst leaf is as a rule a small one, whose Adam update a rounding
    can flip; the median leaf's gap is steady from seed to seed."""
    med = float(np.median([v for v in reference.values()]))
    gaps = {n: abs(program[n] - reference[n]) / max(reference[n], med)
            for n in reference if keep(n)}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, len(gaps), float(np.median(list(gaps.values())))
