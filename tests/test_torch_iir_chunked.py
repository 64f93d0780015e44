"""The card's chunked IIR (``csrc/sosfilt.cu``) held to the JAX package on
the CPU: its scheme in plain PyTorch (``sosfilt_chunked_reference``: chunks
from a zero state, entry states carried by the wrapper's own ``carry_matrix``,
chunks run again) against the Pallas ``_sos_kernel`` in interpret mode and
scipy's float64 ``sosfilt``, with the serving filters.

Bound: 2e-4 x max |x|, the card check's and the JAX kernel's own bound for
one float32 recurrence against another; the scheme with the carry dropped
must lie beyond it.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from imagined_speech_translation_tpu.config import FrontendConfig
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.frontend import SignalFrontend, sos_sections
from imagined_speech_translation_tpu_torch.frontend import filters
from tests.test_torch_models import few_threads  # noqa: F401

T = 1651


def _banks():
    fe = SignalFrontend(FrontendConfig())
    return [fe.sos_bandpass, fe.sos_notch]


@pytest.fixture(scope="module")
def window():
    """Six series of a serving window's length, the JAX kernel's output
    (interpret mode) and scipy's in float64."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 3, T)) * 4.0).astype(np.float32)
    banks = _banks()
    pallas = np.asarray(sosfilt_pallas(banks, jnp.asarray(x), interpret=True))
    f64 = sps.sosfilt(np.vstack(banks).astype(np.float64), x.astype(np.float64), axis=-1)
    return x, pallas, f64


@pytest.mark.parametrize("chunks", [1, 16, 32])
def test_chunked_iir_matches_the_pallas_kernel_and_scipy(window, chunks):
    x, pallas, f64 = window
    chunk_len = filters.chunk_length(T, chunks)
    assert -(-T // chunk_len) == chunks
    got = filters.sosfilt_chunked_reference(_banks(), torch.from_numpy(x), chunk_len).numpy()
    bound = 2e-4 * np.abs(x).max()
    np.testing.assert_allclose(got, pallas, atol=bound)
    np.testing.assert_allclose(got, f64, atol=bound)


@pytest.mark.parametrize("chunks", [16, 32])
def test_chunked_iir_without_the_carry_lies_beyond_the_bound(window, chunks):
    x, pallas, _ = window
    chunk_len = filters.chunk_length(T, chunks)
    dropped = filters.sosfilt_chunked_reference(_banks(), torch.from_numpy(x), chunk_len,
                                                carry=False).numpy()
    assert np.abs(dropped - pallas).max() > 2e-4 * np.abs(x).max()


@pytest.mark.parametrize("chunk_len", [1, 53, 105])
def test_carry_matrix_is_the_cascade_applied_chunk_len_times(chunk_len):
    """Column k of A^L: unit state k after chunk_len samples of zero input,
    stepped through the cascade in float64."""
    coeffs = sos_sections(_banks()).astype(np.float64)
    n = 2 * len(coeffs)
    z = np.eye(n)  # row k: unit state k, as z1, z2 of each section
    for _ in range(chunk_len):
        v = np.zeros(n)
        for s, (b0, b1, b2, a1, a2) in enumerate(coeffs):
            out = b0 * v + z[:, 2 * s]
            z[:, 2 * s] = b1 * v - a1 * out + z[:, 2 * s + 1]
            z[:, 2 * s + 1] = b2 * v - a2 * out
            v = out
    got = filters.carry_matrix(sos_sections(_banks()), chunk_len)
    assert got.shape == (n, n) and got.dtype == np.float64
    np.testing.assert_allclose(got, z.T, rtol=0, atol=1e-12 * np.abs(z).max())


@pytest.mark.parametrize("t_len", [1, 5, 31, 32, 40, 333, 1650, 1651, 70000])
def test_chunk_length_is_odd_and_cuts_at_most_32_chunks(t_len):
    chunk_len = filters.chunk_length(t_len)
    assert chunk_len % 2 == 1
    assert -(-t_len // chunk_len) <= filters.CHUNKS
    assert chunk_len <= -(-t_len // filters.CHUNKS) + 1


def test_chunks_match_the_kernel():
    src = (_kernels.CSRC / "sosfilt.cu").read_text()
    assert int(re.search(r"constexpr int kChunks = (\d+);", src).group(1)) == filters.CHUNKS


@pytest.mark.parametrize("t_len", [5, 40, 333])
def test_chunked_iir_on_ragged_lengths(t_len):
    """T shorter than 32 chunks of one sample, and T that is not a multiple
    of the chunk, against the sequential twin."""
    rng = np.random.default_rng(t_len)
    x = torch.from_numpy((rng.normal(size=(7, t_len)) * 4.0).astype(np.float32))
    got = filters.sosfilt_chunked_reference(_banks(), x, filters.chunk_length(t_len))
    want = filters.sosfilt_reference(_banks(), x)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * x.abs().max().item())


def test_tuning_program_gets_the_serving_sections():
    """``cli/tune_split_bwd.py --program sosfilt`` passes the kernel's own
    float32 coefficients, five sections of b0 b1 b2 a1 a2, exactly."""
    from imagined_speech_translation_tpu_torch.cli import tune_split_bwd

    args = tune_split_bwd.sosfilt_args()
    want = sos_sections(_banks())
    assert want.shape == (5, 5)
    np.testing.assert_array_equal(np.float32([float(a) for a in args]), want.ravel())
