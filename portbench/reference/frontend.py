"""The plain reference of the signal chain, in float64 NumPy and SciPy:
the Butterworth bandpass and the notch of the configuration's ``frontend``
section as second-order sections, run over time by ``scipy.signal.sosfilt``
from a zero state, then the common-average reference over every montage
channel, then the gather of each region's electrodes into the zero-padded
``(R, C)`` layout."""

from __future__ import annotations

import numpy as np
from scipy import signal


def filters(frontend: dict) -> np.ndarray:
    """The cascade of the bandpass's and the notch's sections, float64."""
    fs = frontend["sample_rate_hz"]
    band = signal.butter(frontend["bandpass_order"],
                         [frontend["bandpass_low_hz"], frontend["bandpass_high_hz"]],
                         btype="bandpass", fs=fs, output="sos")
    b, a = signal.iirnotch(frontend["notch_hz"], frontend["notch_q"], fs=fs)
    return np.concatenate([band, signal.tf2sos(b, a)])


def preprocess(raw: np.ndarray, frontend: dict, gather: np.ndarray,
               mask: np.ndarray) -> np.ndarray:
    """Raw ``(N, n_channels, T)`` windows -> ``(N, R, C, T)`` float64 region
    stacks, zero on padded slots."""
    y = signal.sosfilt(filters(frontend), np.asarray(raw, np.float64), axis=-1)
    if frontend["car"]:
        y = y - y.mean(axis=-2, keepdims=True)
    stacked = y[:, gather.reshape(-1)].reshape(y.shape[0], *gather.shape, y.shape[-1])
    return np.where(mask[None, :, :, None], stacked, 0.0)
