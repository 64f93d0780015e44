"""Cross-session batch scheduler: a copy of the JAX package's
``runtime.batcher.BatchScheduler`` with the ``LatencyStats`` it records into
(from ``runtime/streaming.py``).

Many sessions submit ``(C, T)`` windows; the scheduler pads what is pending
to ``max_batch`` rows and calls ``decode_fn`` once per batch, when the batch
fills or ``max_delay_ms`` after the oldest pending window arrived.  One
dispatcher task owns the device, and the decode call runs in a worker
thread so the event loop stays free.  ``tests/test_torch_config.py`` holds
the copy to the original.  The per-session ``BatchingDecodePipeline`` (and
the ``Windower`` it feeds from) is not ported.

Usage::

    async with BatchScheduler(decode_fn, max_batch=16, max_delay_ms=25) as sched:
        text = await sched.submit(window)  # (C, T) float32 -> str
"""

from __future__ import annotations

import asyncio
import statistics
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np


@dataclass
class LatencyStats:
    """Bounded latency telemetry: percentiles over the most recent
    ``window`` samples, cumulative ``count`` over the process lifetime (a
    server-lifetime pipeline must not grow or re-sort an unbounded
    history on every ``latency¬`` control query)."""

    window: int = 10_000
    samples_ms: "deque[float]" = None  # type: ignore[assignment]
    total: int = 0

    def __post_init__(self):
        if self.samples_ms is None:
            self.samples_ms = deque(maxlen=self.window)

    def record(self, seconds: float) -> None:
        self.total += 1
        self.samples_ms.append(seconds * 1e3)

    def summary(self) -> dict:
        if not self.samples_ms:
            return {"count": 0, "p50_ms": None, "p95_ms": None, "mean_ms": None}
        ordered = sorted(self.samples_ms)
        return {
            "count": self.total,
            "p50_ms": statistics.median(ordered),
            "p95_ms": ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))],
            "mean_ms": statistics.fmean(ordered),
        }


class BatchScheduler:
    """Aggregates windows from any number of sessions into fixed-shape
    decode batches."""

    def __init__(
        self,
        decode_fn: Callable[[np.ndarray], Sequence[str]],
        *,
        max_batch: int = 16,
        max_delay_ms: float = 25.0,
        pad_mode: str = "repeat_first",
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pad_mode not in ("repeat_first", "zeros"):
            raise ValueError(f"unknown pad_mode {pad_mode!r}")
        self.decode_fn = decode_fn
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.pad_mode = pad_mode
        self.latency = LatencyStats()
        #: recent per-launch real-row counts (batch-fill telemetry; bounded —
        #: the scheduler lives for the server's lifetime)
        self.fills: deque[int] = deque(maxlen=4096)
        #: cumulative launch count
        self.batches = 0
        self._shape: tuple[int, ...] | None = None
        self._pending: list[tuple[np.ndarray, asyncio.Future, float]] = []
        self._wakeup: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._closed = False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._closed = False
            self._wakeup = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(
                self._dispatch_loop()
            )

    async def stop(self) -> None:
        """Drain pending windows, then stop the dispatcher."""
        if self._task is None:
            return
        self._closed = True
        self._wakeup.set()
        await self._task
        self._task = None

    async def __aenter__(self):
        self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    # -- submission -----------------------------------------------------
    async def submit(self, window: np.ndarray) -> str:
        """Queue one (C, T) window; resolves to its decoded text."""
        if self._task is None:
            raise RuntimeError("scheduler not started")
        if self._closed:
            raise RuntimeError("scheduler stopped")
        window = np.asarray(window, np.float32)
        # reject mismatched shapes HERE so a rogue session can never poison
        # a batch shared with other sessions' windows
        if self._shape is None:
            self._shape = window.shape
        elif window.shape != self._shape:
            raise ValueError(
                f"window shape {window.shape} != scheduler shape {self._shape}"
            )
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((window, fut, time.monotonic()))
        self._wakeup.set()
        return await fut

    # -- dispatcher -----------------------------------------------------
    async def _dispatch_loop(self) -> None:
        while True:
            if not self._pending:
                if self._closed:
                    return
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            if len(self._pending) < self.max_batch and not self._closed:
                # wait out the remainder of the oldest window's deadline,
                # but wake early if the batch fills meanwhile
                deadline = self._pending[0][2] + self.max_delay
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self._wakeup.clear()
                    try:
                        await asyncio.wait_for(
                            self._wakeup.wait(), timeout=remaining
                        )
                    except asyncio.TimeoutError:
                        pass
                    if (
                        len(self._pending) < self.max_batch
                        and not self._closed
                        and time.monotonic() < deadline
                    ):
                        continue
            await self._launch()

    async def _launch(self) -> None:
        take = self._pending[: self.max_batch]
        del self._pending[: len(take)]
        windows = [w for w, _, _ in take]
        n = len(windows)
        self.fills.append(n)
        self.batches += 1
        try:
            # stack/pad inside the guard: a session pushing a mismatched
            # window shape must fail ITS futures, not kill the dispatcher
            # (every later submit would hang forever)
            if n < self.max_batch:
                pad = (
                    windows[0]
                    if self.pad_mode == "repeat_first"
                    else np.zeros_like(windows[0])
                )
                windows = windows + [pad] * (self.max_batch - n)
            batch = np.stack(windows)
            texts = list(await asyncio.to_thread(self.decode_fn, batch))
            if len(texts) < n:
                raise ValueError(
                    f"decode_fn returned {len(texts)} texts for {n} windows"
                )
        except Exception as e:
            for _, fut, _ in take:
                if not fut.done():
                    fut.set_exception(
                        RuntimeError(f"decode failed: {e}")
                    )
            return
        now = time.monotonic()  # latency measured from submission time
        for (_, fut, t_in), text in zip(take, texts[:n]):
            self.latency.record(now - t_in)
            if not fut.done():
                fut.set_result(str(text))

    # -- telemetry ------------------------------------------------------
    def stats(self) -> dict:
        s = self.latency.summary()
        s["batches"] = self.batches
        s["mean_fill"] = (  # over the recent (bounded) fill window
            float(np.mean(self.fills)) if self.fills else None
        )
        return s
