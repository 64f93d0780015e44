"""Cross-session batch scheduler: many device streams, one decode function.

The per-session :class:`~.streaming.DecodePipeline` batches only within a
single device's stream, so a server with many lightly-active sessions runs
the decode function at batch 1-2, paying a whole batch's latency per window
while the card sits mostly idle.  The reference has no equivalent: its Node
plane is request/response and its Dart plane decodes per-message
(``dart_wss``, SURVEY.md §3.5).

Design decisions:

* **One static batch shape.**  Every call pads the collected windows to
  ``max_batch`` rows, so the decode function sees one shape whatever the
  fill.  Padding rows reuse the first window (``pad_mode="zeros"`` pads
  with zeros) and their outputs are dropped.
* **Fill-or-deadline.**  A batch launches when ``max_batch`` windows are
  pending, or ``max_delay_ms`` after the OLDEST pending window arrived:
  bounded added latency under light load, full batches under heavy load.
* **Single dispatcher.**  One background task owns the device: decode
  calls never overlap, and the event loop stays free, since the decode
  call runs in a worker thread.

Usage::

    sched = BatchScheduler(decode_fn, max_batch=16, max_delay_ms=25)
    async with sched:                      # or sched.start()/await sched.stop()
        text = await sched.submit(window)  # (C, T) float32 -> str

Wire into the websocket service with :class:`BatchingDecodePipeline`,
which keeps the per-session windower/wake-gate and awaits the shared
scheduler for the decode itself.

A copy of ``imagined_speech_translation_tpu.runtime.batcher`` (the port
imports nothing of the JAX package); ``tests/test_torch_config.py`` and
``tests/test_torch_runtime.py`` hold the copy to the original.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np

from .streaming import LatencyStats, Windower

logger = logging.getLogger(__name__)


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


class BatchingDecodePipeline:
    """Per-session windower/wake-gate feeding the SHARED scheduler.

    Async drop-in for :class:`~.streaming.DecodePipeline` where decode
    capacity is pooled across sessions: ``feed``/``flush`` are coroutines
    returning decoded utterances for THIS session's windows, in order.
    """

    def __init__(
        self,
        *,
        windower: Windower,
        scheduler: BatchScheduler,
        wake_gate: Callable[[np.ndarray], bool] | None = None,
    ):
        self.windower = windower
        self.scheduler = scheduler
        self.wake_gate = wake_gate or (lambda w: True)

    async def feed(self, samples: np.ndarray) -> list[str]:
        self.windower.ring.push(samples)
        gated = [w for w in self.windower.poll() if self.wake_gate(w)]
        if not gated:
            return []
        results = await asyncio.gather(
            *(self.scheduler.submit(w) for w in gated),
            return_exceptions=True,
        )
        # deliver every window that DID decode; only fail the call when
        # nothing came back (one bad batch must not discard sibling
        # windows' successfully decoded text)
        texts = [r for r in results if isinstance(r, str)]
        failures = [r for r in results if isinstance(r, BaseException)]
        if failures and not texts:
            raise failures[0]
        for f in failures:
            logger.warning("window decode failed: %s", f)
        return texts

    async def flush(self) -> list[str]:
        """Windowing is hop-driven; nothing buffers session-side."""
        return []
