"""STFT log-spectrogram features, batched on the tensor's device.

Port of ``imagined_speech_translation_tpu.frontend.stft``: frames without
padding (``Tensor.unfold``), a scipy window, ``torch.fft.rfft`` over the last
axis, then the magnitude or ``log(|X|^2 + eps)``.  Equals
``scipy.signal.stft`` with ``boundary=None, padded=False`` and no scaling.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps


def get_window(name: str, nperseg: int) -> np.ndarray:
    return sps.get_window(name, nperseg, fftbins=True).astype(np.float64)


def frame_signal(x: torch.Tensor, nperseg: int, hop: int) -> torch.Tensor:
    """``(..., T)`` -> ``(..., F, nperseg)`` frames with hop ``hop`` (no
    padding: F = 1 + (T - nperseg)//hop)."""
    t = x.shape[-1]
    if t < nperseg:
        raise ValueError(f"signal length {t} < nperseg {nperseg}")
    return x.unfold(-1, nperseg, hop)


def stft_magnitude(x: torch.Tensor, *, nperseg: int, hop: int,
                   window: str = "hann") -> torch.Tensor:
    """``(..., T)`` -> ``(..., F, nperseg//2 + 1)`` magnitude spectrogram."""
    win = torch.as_tensor(get_window(window, nperseg), dtype=x.dtype, device=x.device)
    return torch.fft.rfft(frame_signal(x, nperseg, hop) * win, dim=-1).abs()


def log_spectrogram(x: torch.Tensor, *, nperseg: int, hop: int, window: str = "hann",
                    eps: float = 1e-10) -> torch.Tensor:
    """Log-power spectrogram: ``log(|STFT|^2 + eps)``."""
    mag = stft_magnitude(x, nperseg=nperseg, hop=hop, window=window)
    return torch.log(mag.square() + eps)
