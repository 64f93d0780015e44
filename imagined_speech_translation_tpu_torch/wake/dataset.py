"""Python loader for the wake-event CSV corpus.

A copy of ``imagined_speech_translation_tpu.wake.dataset`` (jax-free), so the
port imports nothing of the JAX package; a test holds its code to the
original's.  It mirrors ``wake_native/src/dataset.cpp`` and the reference
``wake_model/dataset/dataset.cpp:13-129``: catalog rows point at per-event
CSVs; every ``average_every`` raw rows are averaged into one (time, velocity)
pair; sequences zero-pad to the corpus max; label = time_rel / average_every.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class WakeDataset:
    data: np.ndarray        # (N, seq_len, 2) float32
    detection_time: np.ndarray  # (N,) float64 seconds
    average_every: int = 7

    @property
    def seq_len(self) -> int:
        return self.data.shape[1]

    def labels(self) -> np.ndarray:
        return (self.detection_time / self.average_every).astype(np.int32)

    def shuffled(self, seed: int) -> "WakeDataset":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.data))
        return WakeDataset(self.data[idx], self.detection_time[idx], self.average_every)


def load_wake_dataset(
    catalog_csv: str | Path,
    training_dir: str | Path,
    *,
    average_every: int = 7,
) -> WakeDataset:
    catalog_csv = Path(catalog_csv)
    training_dir = Path(training_dir)
    rows = []
    with open(catalog_csv, newline="") as fh:
        reader = csv.reader(fh)
        next(reader, None)  # header
        for cells in reader:
            if len(cells) < 3:
                continue
            path = training_dir / f"{cells[0]}.csv"
            if path.exists():
                rows.append((path, float(cells[2])))
    if not rows:
        raise ValueError(f"no training files found via {catalog_csv}")

    sequences, times = [], []
    for path, t_rel in rows:
        raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64)
        if raw.ndim == 1:
            raw = raw[None]
        n_avg = raw.shape[0] // average_every
        trimmed = raw[: n_avg * average_every, 1:3]
        avg = trimmed.reshape(n_avg, average_every, 2).mean(axis=1)
        sequences.append(avg.astype(np.float32))
        times.append(t_rel)

    seq_len = max(s.shape[0] for s in sequences)
    out = np.zeros((len(sequences), seq_len, 2), np.float32)
    for i, s in enumerate(sequences):
        out[i, : s.shape[0]] = s
    return WakeDataset(out, np.asarray(times), average_every)
