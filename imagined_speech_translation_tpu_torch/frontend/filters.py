"""IIR filtering: host-designed second-order sections run over the time axis.

Filters are designed on the host with scipy (float64 Butterworth bandpass and
notch biquads, as in ``imagined_speech_translation_tpu.frontend.filters``).
``sosfilt`` runs every section of every bank fused in one pass: the CUDA
kernel ``csrc/sosfilt.cu`` for a tensor on the card, ``sosfilt_reference``
(the same recurrence, sequential over time and vectorized over series) for a
tensor on the CPU.

The kernel cuts each series into chunks of ``chunk_length(T)`` samples and
carries the cascade's state from chunk to chunk with ``carry_matrix``, the
state transition over one chunk; ``sosfilt_chunked_reference`` is that scheme
in plain PyTorch.
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


#: chunks a series is cut into on the card, at most (``csrc/sosfilt.cu``'s
#: kChunks: one lane each)
CHUNKS = 32


def chunk_length(t_len: int, chunks: int = CHUNKS) -> int:
    """Samples per chunk of the card's chunked IIR: ``T / chunks`` rounded
    up, then up to an odd number, so that the 32 chunks of a warp start in
    32 different shared-memory banks.  ``ceil(T / L) <= chunks``."""
    n = -(-t_len // chunks)
    return n if n % 2 else n + 1


def _zero_input_step(coeffs: np.ndarray, state: np.ndarray) -> np.ndarray:
    """The cascade's states (..., 2n: z1, z2 of section 0, then of 1, ...)
    one sample of zero input later, in float64."""
    z = state.copy()
    v = np.zeros(state.shape[:-1])
    for s, (b0, b1, b2, a1, a2) in enumerate(np.asarray(coeffs, np.float64)):
        out = b0 * v + z[..., 2 * s]
        z[..., 2 * s] = b1 * v - a1 * out + z[..., 2 * s + 1]
        z[..., 2 * s + 1] = b2 * v - a2 * out
        v = out
    return z


def carry_matrix(coeffs: np.ndarray, chunk_len: int) -> np.ndarray:
    """The cascade's state transition over ``chunk_len`` samples, ``A^L``,
    float64 ``(2n, 2n)`` over the states z1, z2 of each section, from the
    ``(n, 5)`` rows of :func:`sos_sections` (the coefficients the kernel
    runs): column k is where one step with zero input takes unit state k,
    raised to the L-th power."""
    n = 2 * len(coeffs)
    a = _zero_input_step(coeffs, np.eye(n)).T
    return np.linalg.matrix_power(a, chunk_len)


def sosfilt_chunked_reference(sos_list, x: torch.Tensor, chunk_len: int,
                              carry: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel's scheme: each chunk of ``chunk_len``
    samples runs from a zero state to its final state z_c; the entry states
    follow from ``s_{c+1} = A^L s_c + z_c`` (``carry_matrix`` in float32);
    each chunk runs again from its entry state.  float32, over the last axis.
    ``carry=False`` drops the carry (every chunk from a zero state): a wrong
    answer for the checks."""
    coeffs = sos_sections(sos_list)
    rows = [[float(c) for c in row] for row in coeffs]
    shape = x.shape
    t_len = shape[-1]
    series = x.to(torch.float32).reshape(-1, t_len)
    n_chunks = -(-t_len // chunk_len)
    chunks = torch.nn.functional.pad(series, (0, n_chunks * chunk_len - t_len))
    chunks = chunks.reshape(len(series), n_chunks, chunk_len)

    def run(state, write):
        z = list(state.unbind(-1))
        ys = []
        for u in range(chunk_len):
            v = chunks[..., u]
            for s, (b0, b1, b2, a1, a2) in enumerate(rows):
                out = b0 * v + z[2 * s]
                z[2 * s] = b1 * v - a1 * out + z[2 * s + 1]
                z[2 * s + 1] = b2 * v - a2 * out
                v = out
            if write:
                ys.append(v)
        return torch.stack(z, -1), (torch.stack(ys, -1) if write else None)

    zeros = chunks.new_zeros(chunks.shape[:2] + (2 * len(rows),))
    final = run(zeros, False)[0]
    entry = zeros.clone()
    if carry:
        a_l = torch.from_numpy(carry_matrix(coeffs, chunk_len).astype(np.float32))
        a_l = a_l.to(series.device)
        s = zeros[:, 0]
        for c in range(n_chunks - 1):
            s = s @ a_l.T + final[:, c]
            entry[:, c + 1] = s
    y = run(entry, True)[1].reshape(len(series), -1)[:, :t_len]
    return y.reshape(shape)


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

    CUDA tensor: the ``sosfilt`` kernel, in chunks of ``chunk_length(T)``
    samples carried by ``carry_matrix``.  CPU tensor:
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
    chunk_len = chunk_length(t_len)
    carry = np.ascontiguousarray(carry_matrix(coeffs, chunk_len), np.float32)
    series = x.reshape(-1, t_len).contiguous()  # (series, T)
    y = torch.empty_like(series)
    SOSFILT.launch(
        series.data_ptr(), y.data_ptr(), series.shape[0], t_len, coeffs.ctypes.data,
        len(coeffs), carry.ctypes.data, chunk_len,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y.reshape(shape)
