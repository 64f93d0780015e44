"""The port's recycling decode worker (``runtime/worker.py``) in the scenarios
of ``tests/test_worker.py``: round trip and stats, recycle on an RSS budget,
crash recovery and a bad budget, with fake decode functions (no device); the
round trip and the crash also through the JAX package's original, with equal
results.

The factories sit at module level (a spawned child unpickles them by
importing this module), and the module imports neither jax nor torch at its
top, so each child starts in about a second.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from imagined_speech_translation_tpu_torch.runtime.worker import DecodeWorker, _rss_mb

_LEAK = []  # lives in the CHILD process only


def _echo_factory():
    def decode_fn(batch):
        return [f"w{i}:{float(batch[i].sum()):.0f}" for i in range(batch.shape[0])]

    return decode_fn


def _leaky_factory():
    def decode_fn(batch):
        _LEAK.append(np.ones(100 * 2**20 // 8))  # retain ~100 MB per call
        return ["leak"] * batch.shape[0]

    return decode_fn


def _crashy_factory():
    def decode_fn(batch):
        if float(batch[0, 0, 0]) == 42.0:
            os._exit(1)  # the child dies mid-call
        if float(batch[0, 0, 0]) == 7.0:
            raise ValueError("bad window")  # the call fails, not the child
        return ["ok"] * batch.shape[0]

    return decode_fn


def _failing_factory():
    raise RuntimeError("no card")


def roundtrip(cls):
    with cls(_echo_factory, rss_budget_mb=1e6) as w:
        batch = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
        out = [w(batch), w(np.zeros((1, 3, 4), np.float32)),
               w(np.arange(4, dtype=np.float16).reshape(1, 1, 4))]
        s = w.stats()
        assert s["child_pid"] is not None
        out.append({k: v for k, v in s.items() if k != "child_pid"})
    assert w._proc is None  # the context's exit stopped the child
    assert out[0] == ["w0:66", "w1:210"] and out[3]["calls"] == 3
    return out


def crash_recovery(cls):
    w = cls(_crashy_factory, rss_budget_mb=1e6)
    w.start()
    try:
        ok = np.zeros((1, 2, 2), np.float32)
        out = [w(ok)]
        for value in (7.0, 42.0):
            bad = ok.copy()
            bad[0, 0, 0] = value
            with pytest.raises(RuntimeError) as e:
                w(bad)
            out.append(str(e.value))
        out += [w(ok), w.recycles, w.calls]  # the next call respawns the child
    finally:
        w.stop()
    assert out[2] == "decode worker crashed" and out[4] == 1
    return out


def test_worker_roundtrip_and_stats():
    roundtrip(DecodeWorker)


def test_worker_recycles_on_rss_budget():
    w = DecodeWorker(_leaky_factory, rss_budget_mb=1.0, check_every=1)
    w.start()
    try:
        pid0 = w._proc.pid
        # a real budget: the baseline + ~250 MB, so ~3 leaky calls trip it
        w.rss_budget_mb = _rss_mb(pid0) + 250.0
        for _ in range(6):
            assert w(np.zeros((1, 2, 2), np.float32)) == ["leak"]
        assert w.recycles >= 1, w.stats()
        assert w._proc.pid != pid0  # a fresh child after the recycle
        assert w.stats()["child_rss_mb"] is not None
        assert w(np.zeros((1, 2, 2), np.float32)) == ["leak"]
    finally:
        w.stop()


def test_worker_crash_recovery():
    crash_recovery(DecodeWorker)


def test_worker_rejects_bad_budget_and_failed_builds():
    with pytest.raises(ValueError):
        DecodeWorker(_echo_factory, rss_budget_mb=0)
    w = DecodeWorker(_failing_factory, rss_budget_mb=1e6)
    with pytest.raises(RuntimeError, match="failed to build: RuntimeError: no card"):
        w.start()
    assert w._proc is None


@pytest.mark.parametrize("scenario", [roundtrip, crash_recovery], ids=lambda s: s.__name__)
def test_worker_copy_matches_jax(scenario):
    from imagined_speech_translation_tpu.runtime.worker import DecodeWorker as JaxWorker

    assert scenario(DecodeWorker) == scenario(JaxWorker)
