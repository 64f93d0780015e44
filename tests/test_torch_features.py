"""The port's single-card leftovers against the JAX package: STFT features
(``frontend/stft.py``, ``SignalFrontend.features``), ``feature_diversity_stats``
and the host feed (``data/feed.py``).

Tolerances.  Magnitudes: float32 against scipy's float64 within 1e-6 x
sum|w| x max|x| (the FFT's rounding; sum|w| = 64 for a 128-point Hann).  A
log-spectrum ``log(|X|^2 + eps)`` cannot carry one absolute bound: where
|X| is near zero a tiny change of X moves it by a lot.  So it is held to the
interval that a bound dX on |X - X_ref| implies,
``[log(max(|X_ref| - dX, 0)^2 + eps), log((|X_ref| + dX)^2 + eps)]``, with
dX = sum|w| x (dy + 1e-6 x max|y|), where dy is the largest difference of
the signals framed: 0 for the STFT alone; for ``features`` the measured
difference of the filtered signals, itself within the IIR's bound, 2e-4 x
max|x| (2e-3 x max|x| for the JAX package's off-TPU associative scan), as
``tests/test_torch_frontend.py`` states.
``feature_diversity_stats``: 1e-6 absolute.  The feed: equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from imagined_speech_translation_tpu.config import FrontendConfig
from imagined_speech_translation_tpu.data import batch_iterator as jax_batch_iterator
from imagined_speech_translation_tpu.data.feed import threaded_producer as jax_threaded_producer
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend import log_spectrogram as jax_log_spectrogram
from imagined_speech_translation_tpu.frontend import stft_magnitude as jax_stft_magnitude
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu.models import feature_diversity_stats as jax_diversity
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.data import (
    ChineseCharTokenizer,
    EEGTextDataset,
    batch_iterator,
    device_prefetch,
    threaded_producer,
)
from imagined_speech_translation_tpu_torch.frontend import (
    SignalFrontend,
    frame_signal,
    log_spectrogram,
    stft_magnitude,
)
from imagined_speech_translation_tpu_torch.frontend.stft import get_window
from imagined_speech_translation_tpu_torch.models import feature_diversity_stats
from tests.helpers import TINY_VOCAB, build_dataset, tiny_config, tiny_tokenizer

NPERSEG, HOP, EPS = 128, 64, 1e-10


def _within_log_interval(got, ref_mag, dx, eps=EPS):
    """Raises unless each log-power of ``got`` lies in the interval that
    |X - X_ref| <= dx implies (module docstring); returns the intervals'
    widths."""
    lo = np.log(np.maximum(ref_mag - dx, 0.0) ** 2 + eps)
    hi = np.log((ref_mag + dx) ** 2 + eps)
    bad = (got < lo - 1e-5 * np.abs(lo)) | (got > hi + 1e-5 * np.abs(hi))
    assert not bad.any(), f"{bad.sum()} of {bad.size} log-power bins outside their interval"
    return hi - lo


def _w1():
    return np.abs(get_window("hann", NPERSEG)).sum()


def test_frame_signal_shapes_and_refusal():
    x = torch.arange(2 * 300, dtype=torch.float32).reshape(2, 300)
    frames = frame_signal(x, NPERSEG, HOP)
    assert frames.shape == (2, 1 + (300 - NPERSEG) // HOP, NPERSEG)
    torch.testing.assert_close(frames[1, 2], x[1, 2 * HOP : 2 * HOP + NPERSEG], rtol=0, atol=0)
    with pytest.raises(ValueError, match="< nperseg"):
        frame_signal(x[:, :100], NPERSEG, HOP)


def test_stft_magnitude_matches_scipy_and_jax():
    x = (np.random.default_rng(5).normal(size=(2, 3, 512)) * 3.0).astype(np.float32)
    _, _, z = sps.stft(x.astype(np.float64), fs=1.0, window="hann", nperseg=NPERSEG,
                       noverlap=NPERSEG - HOP, boundary=None, padded=False)
    ref = (np.abs(z) * get_window("hann", NPERSEG).sum()).swapaxes(-1, -2)
    got = stft_magnitude(torch.from_numpy(x), nperseg=NPERSEG, hop=HOP).numpy()
    assert got.shape == ref.shape == (2, 3, 7, 65) and got.dtype == np.float32
    tol = 1e-6 * _w1() * np.abs(x).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    jax_mag = np.asarray(jax_stft_magnitude(jnp.asarray(x), nperseg=NPERSEG, hop=HOP))
    np.testing.assert_allclose(got, jax_mag, rtol=0, atol=tol)


@pytest.mark.parametrize("window", ["hann", "hamming"])
def test_log_spectrogram_matches_jax(window):
    x = (np.random.default_rng(6).normal(size=(3, 400)) * 5.0).astype(np.float32)
    got = log_spectrogram(torch.from_numpy(x), nperseg=NPERSEG, hop=HOP, window=window).numpy()
    want = np.asarray(jax_log_spectrogram(jnp.asarray(x), nperseg=NPERSEG, hop=HOP,
                                          window=window))
    assert got.shape == want.shape
    frames = np.stack([x[:, i * HOP : i * HOP + NPERSEG] for i in range(got.shape[1])], 1)
    win = get_window(window, NPERSEG)
    ref_mag = np.abs(np.fft.rfft(frames.astype(np.float64) * win, axis=-1))
    dx = np.abs(win).sum() * 1e-6 * np.abs(x).max()
    _within_log_interval(got, ref_mag, dx)
    _within_log_interval(want, ref_mag, dx)


def _features_input():
    x = (np.random.default_rng(7).normal(size=(2, 6, 700)) * 20.0).astype(np.float32)
    return x, np.array([True, True, False, True, True, True])


@pytest.mark.parametrize("masked", [False, True])
def test_features_match_jax(masked):
    x, mask = _features_input()
    mask = mask if masked else None
    cfg = FrontendConfig()
    fe = SignalFrontend(cfg)
    xt, mt = torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)
    got, y_got = fe.features(xt, mt).numpy(), fe.preprocess(xt, mt).numpy()
    jfe = JaxFrontend(cfg)
    jx, jmask = jnp.asarray(x), None if mask is None else jnp.asarray(mask)
    # the JAX chain with the sequential Pallas IIR (interpret): the TPU path
    y_ref = np.asarray(jax_car(sosfilt_pallas([jfe.sos_bandpass, jfe.sos_notch], jx,
                                              interpret=True), jmask))
    tpu_path = np.asarray(jax_log_spectrogram(jnp.asarray(y_ref), nperseg=cfg.stft_nperseg,
                                              hop=cfg.stft_hop, window=cfg.stft_window,
                                              eps=cfg.log_eps))
    # JaxFrontend.features off the TPU: the associative-scan IIR
    off_tpu, y_off = np.asarray(jfe.features(jx, jmask)), np.asarray(jfe.preprocess(jx, jmask))
    n_frames = 1 + (700 - cfg.stft_nperseg) // cfg.stft_hop
    assert got.shape == tpu_path.shape == off_tpu.shape == (2, 6, n_frames, 65)
    frames = np.stack([y_ref[..., i * HOP : i * HOP + NPERSEG] for i in range(n_frames)], -2)
    ref_mag = np.abs(np.fft.rfft(frames.astype(np.float64) * get_window("hann", NPERSEG),
                                 axis=-1))
    scale, top_y = np.abs(x).max(), np.abs(y_ref).max()
    widths = []
    for what, y, bound in ((got, y_got, 2e-4), (tpu_path, y_ref, 0.0), (off_tpu, y_off, 2e-3)):
        dy = np.abs(y - y_ref).max()
        assert dy <= bound * scale
        widths.append(_within_log_interval(what, ref_mag, _w1() * (dy + 1e-6 * top_y),
                                           cfg.log_eps))
    # the port's intervals bind where the signal is: the pass band's bins
    # (a quarter of them) are held within 0.05 in the log; the stop band
    # lies at the float32 rounding floor
    assert (widths[0] < 0.05).mean() > 0.2


def test_features_run_on_the_tensor_device_only():
    with pytest.raises(ValueError, match="unsupported device"):
        SignalFrontend().features(torch.empty((2, 3, 300), device="meta"))


def test_feature_diversity_stats_matches_jax():
    feats = np.random.default_rng(0).normal(size=(3, 4, 16)).astype(np.float32)
    got = feature_diversity_stats(torch.from_numpy(feats))
    want = jax_diversity(jnp.asarray(feats))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["region_similarities"].numpy(),
                               np.asarray(want["region_similarities"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got["diversity_score"]), float(want["diversity_score"]),
                               rtol=0, atol=1e-6)
    same = np.repeat(feats[:, :1], 4, axis=1)
    assert abs(float(feature_diversity_stats(torch.from_numpy(same))["diversity_score"])) < 1e-5


@pytest.fixture(scope="module")
def feed_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("feed_corpus")
    cfg = tiny_config(tiny_tokenizer().vocab_size)
    jax_ds = build_dataset(root, tiny_tokenizer(), cfg)
    port_tok = ChineseCharTokenizer(list(dict.fromkeys(TINY_VOCAB)), eos_token="[EOS]")
    port_ds = EEGTextDataset(str(root / "data"), str(root / "montage.csv"), port_tok,
                             config.Config.from_json(cfg.to_json()).data, augment=False,
                             seed=42)
    return jax_ds, port_ds


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            a = g[k].numpy() if isinstance(g[k], torch.Tensor) else g[k]
            np.testing.assert_array_equal(a, np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, seed=1, epoch=2),
                                dict(drop_last=False)])
def test_batch_iterator_matches_jax(feed_dataset, kw):
    jax_ds, port_ds = feed_dataset
    got = list(batch_iterator(port_ds, np.arange(10), 4, **kw))
    want = list(jax_batch_iterator(jax_ds, np.arange(10), 4, **kw))
    assert len(got) == (3 if kw.get("drop_last") is False else 2)
    _assert_batches_equal(got, want)


def test_threaded_producer_matches_jax_and_raises_on_the_consumer_side(feed_dataset):
    jax_ds, port_ds = feed_dataset
    got = list(threaded_producer(lambda: batch_iterator(port_ds, np.arange(12), 3), depth=2))
    want = list(jax_threaded_producer(lambda: jax_batch_iterator(jax_ds, np.arange(12), 3),
                                      depth=2))
    _assert_batches_equal(got, want)

    def failing():
        yield 1
        yield 2
        raise KeyError("bad sample")

    for producer in (threaded_producer, jax_threaded_producer):
        seen = []
        with pytest.raises(KeyError, match="bad sample"):
            for item in producer(failing, depth=1):
                seen.append(item)
        assert seen == [1, 2]


@pytest.mark.parametrize("size", [1, 2, 5])
def test_device_prefetch_on_the_cpu_yields_the_same_batches(feed_dataset, size):
    _, port_ds = feed_dataset
    host = list(batch_iterator(port_ds, np.arange(12), 4))
    fed = list(device_prefetch(iter(host), size=size, device="cpu"))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for b in fed for v in b.values())
    _assert_batches_equal(fed, host)


def test_device_prefetch_refuses_sharding_and_needs_a_card_unless_asked():
    """``sharding=`` takes a mesh (``tests/test_torch_parallel*.py`` feed
    one); anything else, or a device beside a serving mesh, is refused."""
    from imagined_speech_translation_tpu_torch.parallel import make_mesh

    with pytest.raises(TypeError, match="make_mesh"):
        device_prefetch(iter([]), sharding=object(), device="cpu")
    with pytest.raises(ValueError, match="pass no device"):
        device_prefetch(iter([]), sharding=make_mesh(2, 1, devices=["cpu", "cpu"]),
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_prefetch(iter([]))
