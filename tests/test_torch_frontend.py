"""Port frontend vs the JAX package: the fused IIR (its plain twin against the
Pallas ``_sos_kernel`` in interpret mode and scipy) and the preprocess chain
with and without a channel mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from imagined_speech_translation_tpu.config import FrontendConfig
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu_torch.frontend import (
    SignalFrontend,
    sos_sections,
    sosfilt,
    sosfilt_reference,
)
from tests.test_torch_models import few_threads  # noqa: F401


def _banks():
    fe = SignalFrontend(FrontendConfig())
    return [fe.sos_bandpass, fe.sos_notch]


def test_sosfilt_reference_matches_pallas_interpret_and_scipy():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 333)) * 4.0).astype(np.float32)
    banks = _banks()
    got = sosfilt_reference(banks, torch.from_numpy(x)).numpy()
    scale = np.abs(x).max()
    # the Pallas kernel's own test holds it to scipy at atol 2e-4 on unit
    # signals: the same float32 recurrence, so the same bound, per unit scale
    pallas = np.asarray(sosfilt_pallas(banks, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, pallas, atol=2e-4 * scale)
    ref = sps.sosfilt(np.vstack(banks).astype(np.float64), x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=2e-4 * scale)


def test_sos_sections_divide_by_a0_in_float64():
    sos = np.array([[2.0, 1.0, 0.5, 3.0, 0.3, 0.1]], np.float32)
    got = sos_sections([sos])
    assert got.dtype == np.float32 and got.shape == (1, 5)
    want = (sos[0, [0, 1, 2, 4, 5]].astype(np.float64) / np.float64(sos[0, 3])).astype(np.float32)
    np.testing.assert_array_equal(got[0], want)


def test_sosfilt_on_cpu_is_the_reference():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 40)).astype(np.float32))
    torch.testing.assert_close(sosfilt(_banks(), x), sosfilt_reference(_banks(), x), rtol=0, atol=0)


def test_sosfilt_refuses_non_cuda_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        sosfilt(_banks(), torch.empty((2, 16), device="meta"))


@pytest.mark.parametrize("masked", [False, True])
def test_preprocess_matches_jax(masked):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, 200)).astype(np.float32)
    mask = np.array([True, True, False, True, False, True]) if masked else None
    banks = _banks()
    # JAX chain with the sequential Pallas IIR (interpret) -- the TPU path;
    # the off-TPU associative scan is only within 2e-3 of it
    ref = jax_car(
        sosfilt_pallas(banks, jnp.asarray(x), interpret=True),
        None if mask is None else jnp.asarray(mask),
    )
    got = SignalFrontend().preprocess(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)
    )
    # two float32 recurrences that round differently: the IIR bound above
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4 * np.abs(x).max())
    if masked:  # padded channels keep their filtered signal
        filtered = sosfilt_reference(banks, torch.from_numpy(x))
        torch.testing.assert_close(got[:, 2], filtered[:, 2], rtol=0, atol=0)


def test_frontend_designs_the_jax_filters():
    ours, theirs = SignalFrontend(), JaxFrontend()
    np.testing.assert_array_equal(ours.sos_bandpass, theirs.sos_bandpass)
    np.testing.assert_array_equal(ours.sos_notch, theirs.sos_notch)
