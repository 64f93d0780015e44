"""Chinese generation metrics, numerically matching the reference evaluator
(``main_model/src/evaluation/evaluator.py:23-213``):

* jieba word segmentation (``:32-36``), char-level fallback without jieba;
* sentence-level BLEU-1..4 (uniform weights, NLTK ``SmoothingFunction.method1``)
  averaged over the corpus, ×100 (``:38-72``) — a self-contained BLEU with
  identical numerics is used when nltk is absent;
* ROUGE-1/2/L f-measure on space-joined tokens via ``rouge_score`` (``:74-100``)
  with an identical-numerics fallback;
* set-overlap token precision/recall/F1 (``:111-146``), exact match (``:102``),
  length stats (``:192-198``), and the same empty-pair filtering (``:154-162``).

The trainer-side diversity/collapse statistics (unique-prediction ratio,
``is_repetitive``) live in :func:`prediction_diversity`
(reference: trainer.py:232-239).

A copy of ``imagined_speech_translation_tpu.evaluation.evaluator``:
importing that package loads jax (the package's ``__init__`` pulls in its
models), and the port never does.  ``tests/test_torch_data_pipeline.py``
holds the copy to the original.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

try:
    import jieba

    _HAS_JIEBA = True
except ImportError:  # pragma: no cover
    _HAS_JIEBA = False

try:
    from nltk.translate.bleu_score import SmoothingFunction, sentence_bleu

    _HAS_NLTK = True
except ImportError:  # pragma: no cover
    _HAS_NLTK = False

try:
    from rouge_score import rouge_scorer as _rouge_scorer_mod

    _HAS_ROUGE = True
except ImportError:  # pragma: no cover
    _HAS_ROUGE = False

_BLEU_WEIGHTS = {
    1: (1.0, 0, 0, 0),
    2: (0.5, 0.5, 0, 0),
    3: (1 / 3, 1 / 3, 1 / 3, 0),
    4: (0.25, 0.25, 0.25, 0.25),
}


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _bleu_method1(ref_tokens, pred_tokens, weights) -> float:
    """Self-contained sentence BLEU equal to nltk ``sentence_bleu`` with
    ``SmoothingFunction().method1`` for a single reference."""
    if not pred_tokens:
        return 0.0
    # nltk corpus_bleu short-circuit: zero unigram overlap -> BLEU 0
    uni_overlap = sum(
        min(c, _ngrams(ref_tokens, 1).get(g, 0))
        for g, c in _ngrams(pred_tokens, 1).items()
    )
    if uni_overlap == 0:
        return 0.0
    precisions = []
    for n, w in enumerate(weights, start=1):
        if w == 0:
            continue
        pred_ng = _ngrams(pred_tokens, n)
        ref_ng = _ngrams(ref_tokens, n)
        # nltk modified_precision clamps the denominator to 1
        total = max(len(pred_tokens) - n + 1, 1)
        clipped = sum(min(c, ref_ng.get(g, 0)) for g, c in pred_ng.items())
        if clipped == 0:
            # method1: add epsilon=0.1 to the numerator of zero precisions
            precisions.append((0.1, total))
        else:
            precisions.append((float(clipped), total))
    if not precisions:
        return 0.0
    log_sum = 0.0
    active = [w for w in weights if w > 0]
    for w, (num, den) in zip(active, precisions):
        log_sum += w * math.log(num / den)
    bp = 1.0
    ref_len, pred_len = len(ref_tokens), len(pred_tokens)
    if pred_len < ref_len and pred_len > 0:
        bp = math.exp(1.0 - ref_len / pred_len)
    return bp * math.exp(log_sum)


def _rouge_n_f(ref_tokens, pred_tokens, n) -> float:
    ref_ng = _ngrams(ref_tokens, n)
    pred_ng = _ngrams(pred_tokens, n)
    overlap = sum(min(c, pred_ng.get(g, 0)) for g, c in ref_ng.items())
    r_total = sum(ref_ng.values())
    p_total = sum(pred_ng.values())
    if r_total == 0 or p_total == 0:
        return 0.0
    recall = overlap / r_total
    precision = overlap / p_total
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _lcs_len(a, b) -> int:
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        ai = a[i - 1]
        for j in range(1, n + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def _rouge_l_f(ref_tokens, pred_tokens) -> float:
    lcs = _lcs_len(ref_tokens, pred_tokens)
    if not ref_tokens or not pred_tokens or lcs == 0:
        return 0.0
    recall = lcs / len(ref_tokens)
    precision = lcs / len(pred_tokens)
    return 2 * precision * recall / (precision + recall)


class ChineseEvaluator:
    """``compute_all_metrics(predictions, references)`` → dict of BLEU/ROUGE/
    overlap/exact-match/length metrics (×100 scaling as in the reference)."""

    def __init__(self):
        self._smooth = SmoothingFunction().method1 if _HAS_NLTK else None
        self._rouge = (
            _rouge_scorer_mod.RougeScorer(
                ["rouge1", "rouge2", "rougeL"], use_stemmer=False
            )
            if _HAS_ROUGE
            else None
        )

    # ------------------------------------------------------------------
    def tokenize(self, text: str) -> list[str]:
        if not text:
            return []
        text = text.strip()
        if _HAS_JIEBA:
            return list(jieba.cut(text))
        # char-level fallback: CJK chars individually, latin words whole
        out, word = [], []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif ord(ch) > 0x2E80:
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    # reference-compatible alias (evaluator.py:32)
    tokenize_chinese = tokenize

    # ------------------------------------------------------------------
    def compute_bleu(self, predictions, references, n_gram: int = 4) -> float:
        weights = _BLEU_WEIGHTS.get(n_gram, _BLEU_WEIGHTS[4])
        scores = []
        for pred, ref in zip(predictions, references):
            pred_tokens = self.tokenize(pred)
            ref_tokens = self.tokenize(ref)
            if not pred_tokens:
                scores.append(0.0)
                continue
            if _HAS_NLTK:
                try:
                    s = sentence_bleu(
                        [ref_tokens], pred_tokens, weights=weights,
                        smoothing_function=self._smooth,
                    )
                except Exception:
                    s = 0.0
            else:
                s = _bleu_method1(ref_tokens, pred_tokens, weights)
            scores.append(s)
        return float(np.mean(scores) * 100) if scores else 0.0

    def compute_rouge(self, predictions, references) -> dict:
        """Token-level ROUGE-1/2/L f-measure on jieba tokens.

        Deliberate divergence from the reference (evaluator.py:74-100): the
        ``rouge_score`` library's tokenizer strips all non-``[a-z0-9]``
        characters, so on Chinese text the reference silently scores 0.0 for
        every pair.  The paper reports real ROUGE-L (Table 22), so ROUGE is
        computed here directly on the segmented tokens; numerics match
        ``rouge_score`` exactly on ASCII token streams (see
        tests/test_evaluation.py)."""
        acc = {"rouge1": [], "rouge2": [], "rougeL": []}
        for pred, ref in zip(predictions, references):
            pt = self.tokenize(pred)
            rt = self.tokenize(ref)
            acc["rouge1"].append(_rouge_n_f(rt, pt, 1))
            acc["rouge2"].append(_rouge_n_f(rt, pt, 2))
            acc["rougeL"].append(_rouge_l_f(rt, pt))
        return {k: float(np.mean(v) * 100) if v else 0.0 for k, v in acc.items()}

    def compute_exact_match(self, predictions, references) -> float:
        if not predictions:
            return 0.0
        matches = sum(
            p.strip() == r.strip() for p, r in zip(predictions, references)
        )
        return matches / len(predictions) * 100

    def compute_token_overlap(self, predictions, references) -> dict:
        ps, rs, fs = [], [], []
        for pred, ref in zip(predictions, references):
            pt, rt = set(self.tokenize(pred)), set(self.tokenize(ref))
            if not pt and not rt:
                ps.append(1.0); rs.append(1.0); fs.append(1.0)
            elif not pt:
                ps.append(0.0); rs.append(0.0); fs.append(0.0)
            else:
                o = len(pt & rt)
                p = o / len(pt)
                r = o / len(rt) if rt else 0.0
                f = 2 * p * r / (p + r) if p + r > 0 else 0.0
                ps.append(p); rs.append(r); fs.append(f)
        if not ps:
            return {"precision": 0.0, "recall": 0.0, "f1": 0.0}
        return {
            "precision": float(np.mean(ps) * 100),
            "recall": float(np.mean(rs) * 100),
            "f1": float(np.mean(fs) * 100),
        }

    # ------------------------------------------------------------------
    def compute_all_metrics(self, predictions, references) -> dict:
        if (
            not predictions
            or not references
            or len(predictions) != len(references)
        ):
            return self._empty_metrics()
        pairs = [
            (p, r) for p, r in zip(predictions, references) if p.strip() and r.strip()
        ]
        if not pairs:
            return self._empty_metrics()
        preds, refs = zip(*pairs)

        metrics = {}
        for n in (1, 2, 3, 4):
            metrics[f"bleu_{n}"] = self.compute_bleu(preds, refs, n_gram=n)
        rouge = self.compute_rouge(preds, refs)
        metrics.update(
            rouge_1_f=rouge["rouge1"], rouge_2_f=rouge["rouge2"],
            rouge_l_f=rouge["rougeL"],
        )
        overlap = self.compute_token_overlap(preds, refs)
        metrics.update(
            token_precision=overlap["precision"],
            token_recall=overlap["recall"],
            token_f1=overlap["f1"],
        )
        metrics["exact_match"] = self.compute_exact_match(preds, refs)
        pl = [len(self.tokenize(p)) for p in preds]
        rl = [len(self.tokenize(r)) for r in refs]
        metrics.update(
            avg_pred_length=float(np.mean(pl)),
            avg_ref_length=float(np.mean(rl)),
            length_ratio=float(np.mean(pl) / np.mean(rl)) if np.mean(rl) > 0 else 0.0,
            valid_pairs=len(pairs),
            total_pairs=len(predictions),
        )
        return metrics

    @staticmethod
    def _empty_metrics() -> dict:
        return {
            "bleu_1": 0.0, "bleu_2": 0.0, "bleu_3": 0.0, "bleu_4": 0.0,
            "rouge_1_f": 0.0, "rouge_2_f": 0.0, "rouge_l_f": 0.0,
            "token_precision": 0.0, "token_recall": 0.0, "token_f1": 0.0,
            "exact_match": 0.0, "avg_pred_length": 0.0, "avg_ref_length": 0.0,
            "length_ratio": 0.0, "valid_pairs": 0, "total_pairs": 0,
        }


def prediction_diversity(predictions, *, min_diversity: float = 0.3) -> dict:
    """Unique-prediction diversity + collapse flag
    (reference: trainer.py:232-239)."""
    if not predictions:
        return {
            "diversity_score": 0.0,
            "unique_predictions": 0,
            "total_predictions": 0,
            "is_repetitive": True,
        }
    unique = len(set(predictions))
    score = unique / len(predictions)
    return {
        "diversity_score": score,
        "unique_predictions": unique,
        "total_predictions": len(predictions),
        "is_repetitive": score < min_diversity,
    }
