"""Tracing/profiling facade.

Port of ``imagined_speech_translation_tpu.utils.profiling``: ``trace`` runs
``torch.profiler`` over host and, where there is a card, device activity and
writes a Chrome trace (chrome://tracing or Perfetto) in place of the JAX
xplane; ``annotate`` is ``torch.profiler.record_function``; ``StepTimer`` is
copied unchanged.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block and write its Chrome trace to ``log_dir/trace.json``
    (the path the block receives)::

        with trace("build/profile/step") as path:
            train_step(...)
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (a ``user_annotation`` span)."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling step-time statistics for steady-state throughput reporting."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: float | None = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    @property
    def mean_s(self) -> float | None:
        return sum(self._times) / len(self._times) if self._times else None

    def throughput(self, items_per_step: int) -> float | None:
        m = self.mean_s
        return items_per_step / m if m else None
