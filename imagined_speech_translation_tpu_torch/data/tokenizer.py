"""Host-side BERT-style WordPiece tokenizer (self-contained, no downloads).

A copy of ``imagined_speech_translation_tpu.data.tokenizer``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data.py`` holds the copy to the original.

The reference uses the HF ``fnlp/bart-base-chinese`` tokenizer — a BERT
WordPiece tokenizer over a 51,271-token Chinese vocab (SURVEY.md §2.7;
``main_model/scripts/train.py:53``).  The checkpoint cannot be assumed
present, so this module implements the BERT tokenization algorithm from a
local ``vocab.txt``: basic tokenization (lowercase, CJK character spacing,
punctuation splitting, accent stripping) + greedy longest-match WordPiece.
Numerics are validated against ``transformers.BertTokenizer`` in tests.

``encode`` mirrors the reference's ``_safe_tokenize``
(``main_model/src/data/dataset.py:422-494``): pad/truncate to ``max_length``
with ``[CLS] … [SEP]``, clamp out-of-range ids, build shifted decoder inputs
and ``-100``-masked labels.
"""

from __future__ import annotations

import unicodedata
from pathlib import Path

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """BERT basic + WordPiece tokenization from an in-memory vocab."""

    def __init__(
        self,
        vocab: dict[str, int] | list[str],
        *,
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        max_chars_per_word: int = 100,
    ):
        if isinstance(vocab, list):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str | Path, **kw) -> "WordPieceTokenizer":
        toks = Path(path).read_text(encoding="utf-8").splitlines()
        return cls([t.rstrip("\n") for t in toks], **kw)

    # -- basic tokenization ------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
            # split on punctuation
            cur: list[str] = []
            for ch in tok:
                if _is_punct(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    # -- wordpiece ---------------------------------------------------------
    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class ChineseCharTokenizer(WordPieceTokenizer):
    """The full tokenizer facade used by the data pipeline: WordPiece core
    plus special-token handling, fixed-length encoding, decoder-input/label
    construction, and decoding (reference: dataset.py:422-516 plus HF
    ``tokenizer.decode`` used in eval, trainer.py:183-197)."""

    def __init__(
        self,
        vocab,
        *,
        pad_token: str = "[PAD]",
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        mask_token: str = "[MASK]",
        eos_token: str | None = None,
        do_lower_case: bool = True,
    ):
        super().__init__(vocab, do_lower_case=do_lower_case, unk_token=unk_token)
        self.pad_token = pad_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.mask_token = mask_token
        self.pad_token_id = self.vocab[pad_token]
        self.cls_token_id = self.vocab[cls_token]
        self.sep_token_id = self.vocab[sep_token]
        # BART-over-BERT-vocab convention (fnlp/bart-base-chinese): BOS=[CLS],
        # EOS is a dedicated token (logged id 104) when present, else [SEP].
        self.bos_token_id = self.cls_token_id
        if eos_token is not None and eos_token in self.vocab:
            self.eos_token_id = self.vocab[eos_token]
        else:
            self.eos_token_id = self.sep_token_id
        self.special_ids = {
            self.pad_token_id,
            self.cls_token_id,
            self.sep_token_id,
            self.vocab.get(mask_token, -1),
            self.vocab.get(unk_token, -1),
            self.bos_token_id,
            self.eos_token_id,
        }

    @classmethod
    def from_vocab_file(cls, path, **kw):
        toks = Path(path).read_text(encoding="utf-8").splitlines()
        return cls([t.rstrip("\n") for t in toks], **kw)

    @classmethod
    def from_pretrained_dir(cls, directory, **kw):
        """Load from an HF checkpoint directory (``vocab.txt`` +
        optional ``tokenizer_config.json`` special-token overrides +
        ``special_tokens_map.json``)."""
        import json

        d = Path(directory)
        vocab_file = d / "vocab.txt"
        if not vocab_file.exists():
            raise FileNotFoundError(f"no vocab.txt under {directory}")
        overrides = {}
        for cfg_name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = d / cfg_name
            if p.exists():
                try:
                    data = json.loads(p.read_text())
                except json.JSONDecodeError:
                    continue
                for k in ("pad_token", "unk_token", "cls_token", "sep_token",
                          "mask_token", "eos_token"):
                    v = data.get(k)
                    if isinstance(v, dict):
                        v = v.get("content")
                    if isinstance(v, str):
                        overrides[k] = v
                if "do_lower_case" in data:
                    overrides["do_lower_case"] = bool(data["do_lower_case"])
        overrides.update(kw)
        return cls.from_vocab_file(vocab_file, **overrides)

    # ------------------------------------------------------------------
    def encode(self, text: str, max_length: int) -> dict[str, np.ndarray]:
        """``[CLS] tokens [SEP]`` padded/truncated to ``max_length``
        (HF single-sequence semantics: body truncated to max_length-2)."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        ids = ids[: max_length - 2]
        ids = [self.cls_token_id] + ids + [self.sep_token_id]
        attn = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.pad_token_id] * pad
        attn = attn + [0] * pad
        return {
            "input_ids": np.asarray(ids, dtype=np.int32),
            "attention_mask": np.asarray(attn, dtype=np.int32),
        }

    def encode_for_seq2seq(self, text: str, max_length: int) -> dict[str, np.ndarray]:
        """Reference ``_safe_tokenize`` outputs (dataset.py:460-490):
        decoder inputs = ``[bos] + input_ids[:-1]``, labels = input_ids with
        pad → -100."""
        if not isinstance(text, str) or not text.strip():
            text = "数据样本"  # reference default text (dataset.py:427)
        enc = self.encode(text.strip(), max_length)
        input_ids = np.clip(enc["input_ids"], 0, self.vocab_size - 1)
        start = self.bos_token_id
        decoder_input_ids = np.concatenate([[start], input_ids[:-1]]).astype(np.int32)
        labels = np.where(input_ids == self.pad_token_id, -100, input_ids).astype(
            np.int32
        )
        return {
            "decoder_input_ids": decoder_input_ids,
            "labels": labels,
            "attention_mask": enc["attention_mask"],
        }

    def fallback_encoding(self, max_length: int) -> dict[str, np.ndarray]:
        """Zero-information sample (reference: dataset.py:496-509)."""
        safe = min(self.eos_token_id, self.vocab_size - 1)
        dec = np.full(max_length, self.pad_token_id, np.int32)
        dec[0] = safe
        labels = np.full(max_length, -100, np.int32)
        labels[0] = safe
        attn = np.zeros(max_length, np.int32)
        attn[0] = 1
        return {
            "decoder_input_ids": dec,
            "labels": labels,
            "attention_mask": attn,
        }

    # ------------------------------------------------------------------
    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i < 0:
                continue
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.ids_to_tokens.get(i, self.unk_token))
        # BERT-style detok: join wordpieces, drop spaces between CJK chars
        text = " ".join(toks).replace(" ##", "")
        out = []
        chars = text.split(" ")
        for i, w in enumerate(chars):
            if i > 0 and not (
                (w and _is_cjk(ord(w[0]))) and (chars[i - 1] and _is_cjk(ord(chars[i - 1][-1])))
            ):
                out.append(" ")
            out.append(w)
        return "".join(out).strip()

    def batch_decode(self, batch_ids, **kw) -> list[str]:
        return [self.decode(ids, **kw) for ids in batch_ids]
