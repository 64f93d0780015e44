"""IIR filtering: host-designed second-order sections run over the time axis.

Filters are designed on the host with scipy (float64 Butterworth bandpass and
notch biquads, as in ``imagined_speech_translation_tpu.frontend.filters``).
``sosfilt`` runs every section of every bank fused in one pass: the CUDA
kernel ``csrc/sosfilt.cu`` for a tensor on the card, ``sosfilt_reference``
(the same recurrence, sequential over time and vectorized over series) for a
tensor on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps

from .._kernels import SOSFILT, library


def design_bandpass(low_hz: float, high_hz: float, fs: float, order: int = 4) -> np.ndarray:
    """Butterworth bandpass as (sections, 6) SOS, float64."""
    return sps.butter(order, [low_hz, high_hz], btype="bandpass", fs=fs, output="sos")


def design_notch(freq_hz: float, q: float, fs: float) -> np.ndarray:
    """IIR notch as a single SOS section."""
    b, a = sps.iirnotch(freq_hz, q, fs=fs)
    return sps.tf2sos(b, a)


def sos_sections(sos_list) -> np.ndarray:
    """All sections of all banks as float32 ``(n, 5)`` rows ``b0 b1 b2 a1 a2``,
    divided by ``a0`` in float64 before the cast (as the TPU wrapper does)."""
    rows = []
    for sos in sos_list:
        for b0, b1, b2, a0, a1, a2 in np.asarray(sos, np.float64):
            rows.append([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0])
    return np.asarray(rows, np.float64).astype(np.float32)


def sosfilt_reference(sos_list, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: transposed direct-form II biquads,
    zero initial state, float32, a loop over time vectorized over ``(..., T)``'s
    leading axes."""
    coeffs = [[float(c) for c in row] for row in sos_sections(sos_list)]
    shape = x.shape
    xt = x.to(torch.float32).reshape(-1, shape[-1]).t()  # (T, series)
    y = torch.empty_like(xt)
    z1 = [torch.zeros_like(xt[0]) for _ in coeffs]
    z2 = [torch.zeros_like(xt[0]) for _ in coeffs]
    for t in range(xt.shape[0]):
        v = xt[t]
        for s, (b0, b1, b2, a1, a2) in enumerate(coeffs):
            out = b0 * v + z1[s]
            z1[s] = b1 * v - a1 * out + z2[s]
            z2[s] = b2 * v - a2 * out
            v = out
        y[t] = v
    return y.t().reshape(shape)


def sosfilt(sos_list, x: torch.Tensor) -> torch.Tensor:
    """Cascaded ``sosfilt`` over the last axis of float32 ``(..., T)``.

    CUDA tensor: the ``sosfilt`` kernel over a ``(T, series)`` copy, so that
    neighbouring threads touch neighbouring addresses.  CPU tensor:
    :func:`sosfilt_reference`."""
    if x.device.type == "cpu":
        return sosfilt_reference(sos_list, x)
    if x.device.type != "cuda":
        raise ValueError(f"sosfilt: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"sosfilt kernel takes float32, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("sosfilt: empty input")
    coeffs = np.ascontiguousarray(sos_sections(sos_list))
    n_max = library().ist_sosfilt_max_sections()
    if len(coeffs) > n_max:
        raise ValueError(f"sosfilt kernel takes at most {n_max} sections, got {len(coeffs)}")
    shape = x.shape
    t_len = shape[-1]
    xt = x.reshape(-1, t_len).t().contiguous()  # (T, series)
    yt = torch.empty_like(xt)
    SOSFILT.launch(
        xt.data_ptr(), yt.data_ptr(), xt.shape[1], t_len,
        coeffs.ctypes.data, len(coeffs), torch.cuda.current_stream(x.device).cuda_stream,
    )
    return yt.t().reshape(shape)
