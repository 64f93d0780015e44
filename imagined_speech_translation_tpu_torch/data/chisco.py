"""Chisco pickle corpus: discovery, lazy sample index, cached loading.

Reference: ``main_model/src/data/dataset.py:71-100`` (index without loading),
``:153-170`` (cached single-sample load), ``:401-420`` (validation).  The
reference's ``@lru_cache`` on an instance method leaks dataset objects
(SURVEY.md §2.9 bug 3); here the cache lives on the corpus object and caches
whole deserialized files keyed by path.

Each pickle holds a list of samples (or a single dict); a sample is
``{'input_features': array broadcastable to (1, 125, T), 'text': str}``.

A copy of ``imagined_speech_translation_tpu.data.chisco``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data_pipeline.py`` holds the copy to
the original.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def validate_sample(sample, n_channels_total: int = 125) -> bool:
    """Structure/shape validation (reference: dataset.py:401-420 checks
    ``shape[1] == 125`` on the raw array)."""
    if not isinstance(sample, dict):
        return False
    if "input_features" not in sample or "text" not in sample:
        return False
    feats = sample["input_features"]
    if not isinstance(feats, (list, np.ndarray)):
        return False
    arr = np.asarray(feats)
    if arr.ndim < 2 or arr.shape[1] != n_channels_total:
        return False
    return True


def clean_eeg(eeg_data) -> np.ndarray | None:
    """Raw features → ``(channels, T)`` float32, nan/inf scrubbed
    (reference: ``_process_raw_eeg``, dataset.py:172-191)."""
    try:
        eeg = np.asarray(eeg_data, dtype=np.float32).squeeze()
        if eeg.ndim == 1:
            eeg = eeg.reshape(1, -1)
        elif eeg.ndim > 2:
            eeg = eeg.reshape(eeg.shape[0], -1)
        if not np.isfinite(eeg).all():
            eeg = np.nan_to_num(eeg, nan=0.0, posinf=10.0, neginf=-10.0)
        return eeg
    except Exception:
        return None


@dataclass(frozen=True)
class SampleRef:
    file: str
    index: int


class ChiscoCorpus:
    """Lazy pickle corpus with a bounded whole-file LRU cache."""

    def __init__(
        self,
        data_dir: str | Path,
        *,
        max_samples: int | None = None,
        cache_files: int = 32,
        n_channels_total: int = 125,
    ):
        self.data_dir = str(data_dir)
        self.n_channels_total = n_channels_total
        self._cache: OrderedDict[str, object] = OrderedDict()
        self._cache_files = cache_files
        self.files = self._discover()
        self.sample_index = self._build_index(max_samples)

    # ------------------------------------------------------------------
    def _discover(self) -> list[str]:
        if not os.path.exists(self.data_dir):
            raise FileNotFoundError(f"Data directory not found: {self.data_dir}")
        files = sorted(
            os.path.join(self.data_dir, f)
            for f in os.listdir(self.data_dir)
            if f.endswith(".pkl")
        )
        if not files:
            raise ValueError(f"No .pkl files found in {self.data_dir}")
        return files

    def _build_index(self, max_samples) -> list[SampleRef]:
        index: list[SampleRef] = []
        for path in self.files:
            try:
                loaded = self._load_file(path)
            except Exception:
                continue
            n = len(loaded) if isinstance(loaded, list) else 1
            for i in range(n):
                index.append(SampleRef(path, i))
                if max_samples and len(index) >= max_samples:
                    return index
        return index

    # ------------------------------------------------------------------
    def _load_file(self, path: str):
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        with open(path, "rb") as fh:
            loaded = pickle.load(fh)
        self._cache[path] = loaded
        if len(self._cache) > self._cache_files:
            self._cache.popitem(last=False)
        return loaded

    def load(self, ref: SampleRef):
        try:
            loaded = self._load_file(ref.file)
        except Exception:
            return None
        if isinstance(loaded, list):
            return loaded[ref.index] if ref.index < len(loaded) else None
        return loaded if ref.index == 0 else None

    def __len__(self) -> int:
        return len(self.sample_index)

    def get(self, idx: int):
        """Validated sample or None."""
        if idx < 0 or idx >= len(self.sample_index):
            return None
        sample = self.load(self.sample_index[idx])
        if sample is None or not validate_sample(sample, self.n_channels_total):
            return None
        return sample
