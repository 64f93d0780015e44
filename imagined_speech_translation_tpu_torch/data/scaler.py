"""Robust per-channel normalization with sklearn-``RobustScaler`` parity.

The reference fits one ``sklearn.preprocessing.RobustScaler(quantile_range=
(5.0, 95.0))`` per brain region, treating timepoints as observations and
channels as features (``main_model/src/data/dataset.py:102-151``: data lists
are concatenated along time then transposed), and applies it per sample
(``dataset.py:211``: ``scaler.transform(region_data.T).T``).

This implementation reproduces sklearn's numerics exactly:
``center = median``, ``scale = q_hi - q_lo`` (linear-interpolated percentiles)
with sklearn's ``_handle_zeros_in_scale`` semantics (scale==0 → 1).  It is
vectorized over all regions at once on the stacked ``(R, C_max, T)`` layout,
and its state is two small arrays — trivially serializable and shippable to
the device as constants so the transform can fuse into the on-chip frontend.

A copy of ``imagined_speech_translation_tpu.data.scaler``: importing that
package loads jax (``data/__init__.py`` imports the device feed), and the
port never does.  ``tests/test_torch_data_pipeline.py`` holds the copy to
the original.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


def _handle_zeros(scale: np.ndarray) -> np.ndarray:
    # sklearn._handle_zeros_in_scale: zeros (and near-zeros) -> 1.0
    out = scale.copy()
    out[out < 10 * np.finfo(out.dtype).eps] = 1.0
    return out


@dataclass
class RegionRobustScaler:
    """Per-(region, channel-slot) robust center/scale on the stacked layout.

    ``center_``/``scale_`` have shape ``(R, C_max)``; padded slots get
    center 0 / scale 1 so they stay exactly zero after transform.
    """

    quantile_range: tuple[float, float] = (5.0, 95.0)
    center_: np.ndarray | None = None
    scale_: np.ndarray | None = None

    # ------------------------------------------------------------------
    def fit(self, stacked_samples: np.ndarray, channel_mask: np.ndarray) -> "RegionRobustScaler":
        """Fit from ``(N, R, C_max, T)`` stacked samples.

        Matches the reference's fit distribution: per region, observations are
        all timepoints of all sampled items (dataset.py:144 concatenates along
        time before fitting).
        """
        n, r, c, t = stacked_samples.shape
        # (R, C, N*T): observations along the last axis
        obs = np.moveaxis(stacked_samples, 0, 2).reshape(r, c, n * t).astype(np.float64)
        q_lo, q_hi = self.quantile_range
        center = np.median(obs, axis=-1)
        lo = np.percentile(obs, q_lo, axis=-1)
        hi = np.percentile(obs, q_hi, axis=-1)
        scale = _handle_zeros(hi - lo)
        center = np.where(channel_mask, center, 0.0)
        scale = np.where(channel_mask, scale, 1.0)
        self.center_ = center.astype(np.float32)
        self.scale_ = scale.astype(np.float32)
        return self

    def transform(self, stacked: np.ndarray) -> np.ndarray:
        """Transform ``(..., R, C_max, T)``."""
        if self.center_ is None:
            raise RuntimeError("scaler not fitted")
        return ((stacked - self.center_[..., None]) / self.scale_[..., None]).astype(
            np.float32
        )

    def inverse_transform(self, stacked: np.ndarray) -> np.ndarray:
        if self.center_ is None:
            raise RuntimeError("scaler not fitted")
        return (stacked * self.scale_[..., None] + self.center_[..., None]).astype(
            np.float32
        )

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        if self.center_ is None:
            raise RuntimeError("scaler not fitted")
        Path(path).write_text(
            json.dumps(
                {
                    "quantile_range": list(self.quantile_range),
                    "center": self.center_.tolist(),
                    "scale": self.scale_.tolist(),
                }
            )
        )

    @classmethod
    def load(cls, path: str | Path) -> "RegionRobustScaler":
        d = json.loads(Path(path).read_text())
        obj = cls(quantile_range=tuple(d["quantile_range"]))
        obj.center_ = np.asarray(d["center"], dtype=np.float32)
        obj.scale_ = np.asarray(d["scale"], dtype=np.float32)
        return obj
