"""Tracing/profiling facade.

Port of ``imagined_speech_translation_tpu.utils.profiling``: ``trace`` runs
``torch.profiler`` over host and, where there is a card, device activity and
writes a Chrome trace (chrome://tracing or Perfetto) in place of the JAX
xplane; ``annotate`` is ``torch.profiler.record_function``; ``StepTimer`` is
copied unchanged.  On a card ``trace`` also checks that the trace holds
every kernel the block launched (:func:`check_whole`).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

SENTINEL = "spin_kernel"  # the kernel of torch.cuda._sleep, which no program launches
SENTINELS = 256
BLOCK = "traced_block"  # the annotation around the block, on a card


class IncompleteTrace(RuntimeError):
    """A card's trace lacks device records of kernels the block launched."""


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block and write its Chrome trace to ``log_dir/trace.json``
    (the path the block receives)::

        with trace("build/profile/step") as path:
            train_step(...)
            torch.cuda.synchronize()

    On a card the profiler can drop device records: a process that has run
    many profiler sessions loses those of a session's first kernels (up to
    tens of them), and a long block can lose some in its middle.  So the
    session opens with ``SENTINELS`` launches of ``torch.cuda._sleep``'s
    kernel and a synchronize, the block runs inside a ``BLOCK`` annotation
    and ends with a synchronize, and the trace is checked by
    :func:`check_whole` (raising :class:`IncompleteTrace`) before the file
    is written with the block's events alone (:func:`block_events`)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        if not cuda:
            yield path
        else:
            for _ in range(SENTINELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            with torch.profiler.record_function(BLOCK):
                yield path
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    if cuda:
        doc = json.loads(path.read_text())
        check_whole(doc["traceEvents"])
        doc["traceEvents"] = block_events(doc["traceEvents"])
        path.write_text(json.dumps(doc))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (a ``user_annotation`` span)."""
    with torch.profiler.record_function(name):
        yield


def _is_launch(e: dict) -> bool:
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")


def check_whole(events: list[dict]) -> None:
    """Raises :class:`IncompleteTrace` unless a sentinel kernel is in the
    trace and every kernel launch of the block (a ``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ... event of the host's runtime or driver API
    within :func:`block_events`) has its kernel record, matched by the
    ``correlation`` id.  The records lost at a session's head are the first
    ones: the sentinels' own launches may lack theirs."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not any(SENTINEL in e.get("name", "") for e in kernels):
        raise IncompleteTrace(f"the trace lacks all {SENTINELS} sentinels: it may lack the "
                              "device records of the block's first kernels too")
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in block_events(events) if _is_launch(e)]
    missing = [e for e in launches if e.get("args", {}).get("correlation") not in recorded]
    if missing:
        raise IncompleteTrace(f"{len(missing)} of the block's {len(launches)} kernel launches "
                              f"have no device record (first: {missing[0].get('name')} at "
                              f"{missing[0].get('ts')})")


def block_events(events: list[dict]) -> list[dict]:
    """The events of the ``BLOCK`` annotation's span and after (metadata
    kept), without the sentinels: what the block did."""
    start = min(e["ts"] for e in events if e.get("name") == BLOCK and "ts" in e)
    return [e for e in events if e.get("ph") == "M" or (
        float(e.get("ts", start)) >= start and SENTINEL not in e.get("name", ""))]


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
