"""Electrode → brain-region mapping and the stacked-region tensor layout.

A copy of ``imagined_speech_translation_tpu.data.regions``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data.py`` holds the copy to the original.

The 48-electrode / 4-region assignment reproduces the reference's fixed map
(``main_model/src/data/utils.py:5-28``, which matches the paper's Table 1):
frontal 16, temporal 9, central 11, parietal 12.

TPU-first layout: instead of four ragged per-region arrays (the reference
yields a python list of ``(C_r, T)`` arrays, dataset.py:323-326), we gather
all regions into one dense ``(R=4, C_max=16, T)`` tensor with a boolean
channel mask.  Ragged shapes would force four separately-compiled programs
and tiny MXU tiles; the stacked layout keeps everything in one ``vmap`` over
the region axis.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np

REGION_NAMES: tuple[str, ...] = ("frontal", "temporal", "central", "parietal")

ELECTRODE_REGIONS: dict[str, tuple[str, ...]] = {
    "frontal": (
        "FC5", "F5", "F7", "F3", "FC1", "F1", "AF3", "Fz",
        "FC2", "F2", "AF4", "Fp2", "F4", "F6", "F8", "FC6",
    ),
    "temporal": (
        "T9", "FT9", "T7", "TP7", "FT8", "T10", "FT10", "T8", "TP8",
    ),
    "central": (
        "C5", "C3", "FC3", "C1", "CP1", "Cz",
        "CP2", "C2", "C4", "FC4", "C6",
    ),
    "parietal": (
        "P7", "P5", "CP3", "P3", "PO3", "PO1",
        "PO2", "P4", "PO4", "P6", "CP4", "P8",
    ),
}


def get_electrode_regions() -> dict[str, list[str]]:
    """Reference-compatible accessor (src/data/utils.py:5)."""
    return {k: list(v) for k, v in ELECTRODE_REGIONS.items()}


def load_montage(csv_path: str | Path) -> list[str]:
    """Read electrode labels from a montage CSV with a ``label`` column
    (reference: dataset.py:37-38 via pandas; plain csv here)."""
    with open(csv_path, newline="") as fh:
        reader = csv.DictReader(fh)
        if reader.fieldnames is None or "label" not in reader.fieldnames:
            raise ValueError(f"montage {csv_path} missing 'label' column")
        return [row["label"] for row in reader]


def build_region_indices(ch_names) -> dict[str, list[int]]:
    """Map channel-name order → per-region channel indices
    (reference: dataset.py:339-353)."""
    names = list(ch_names)
    out = {}
    for region in REGION_NAMES:
        members = set(ELECTRODE_REGIONS[region])
        out[region] = [i for i, ch in enumerate(names) if ch in members]
    return out


@dataclass(frozen=True)
class RegionSpec:
    """Precomputed gather plan for the stacked-region layout.

    ``gather_indices[r, c]`` is the montage channel index feeding region ``r``
    slot ``c`` (0 for padded slots), ``channel_mask[r, c]`` whether the slot is
    a real channel.
    """

    region_names: tuple[str, ...]
    counts: tuple[int, ...]
    max_channels: int
    gather_indices: np.ndarray  # (R, C_max) int32
    channel_mask: np.ndarray    # (R, C_max) bool

    @classmethod
    def from_channel_names(cls, ch_names, max_channels: int | None = None) -> "RegionSpec":
        indices = build_region_indices(ch_names)
        for region, idx in indices.items():
            if not idx:
                raise ValueError(f"No channels found for {region} region")
        counts = tuple(len(indices[r]) for r in REGION_NAMES)
        cmax = max_channels or max(counts)
        if cmax < max(counts):
            raise ValueError("max_channels smaller than largest region")
        gather = np.zeros((len(REGION_NAMES), cmax), dtype=np.int32)
        mask = np.zeros((len(REGION_NAMES), cmax), dtype=bool)
        for r, region in enumerate(REGION_NAMES):
            idx = indices[region]
            gather[r, : len(idx)] = idx
            mask[r, : len(idx)] = True
        return cls(
            region_names=REGION_NAMES,
            counts=counts,
            max_channels=cmax,
            gather_indices=gather,
            channel_mask=mask,
        )

    # ------------------------------------------------------------------
    def stack(self, eeg: np.ndarray) -> np.ndarray:
        """Gather ``(n_channels, T)`` → ``(R, C_max, T)`` with zero padding."""
        out = eeg[self.gather_indices.reshape(-1)].reshape(
            len(self.region_names), self.max_channels, eeg.shape[-1]
        )
        return np.where(self.channel_mask[..., None], out, 0.0).astype(eeg.dtype)

    def split(self, stacked: np.ndarray) -> list[np.ndarray]:
        """Inverse convenience: stacked ``(R, C_max, T)`` → list of ragged
        ``(C_r, T)`` arrays in reference order."""
        return [stacked[r, : self.counts[r]] for r in range(len(self.region_names))]

    @property
    def total_channels(self) -> int:
        return sum(self.counts)
