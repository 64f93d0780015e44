"""Streaming decode pipeline: ring buffer -> wake gate -> windower -> batched
decode, with latency instrumentation.

The reference's end-to-end product path (SURVEY.md §3.5) is: hardware streams
raw EEG -> on-device wake CNN gates -> windows of (125ch, T=1651) -> model ->
Chinese token ids -> text.  Here the server-side pipeline is explicit and
testable: a per-channel ring buffer absorbs device bytes, a wake gate decides
when a window is worth decoding, windows are batched and fed to one
preprocess+decode function (``cli.serve.build_decode_fn``), and
per-utterance latency is tracked.

A copy of ``imagined_speech_translation_tpu.runtime.streaming`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py`` holds
the copy to the original.  ``runtime.batcher`` imports its ``LatencyStats``
and ``Windower`` from here, as the original does.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


class RingBuffer:
    """Fixed-capacity (channels, time) sample ring."""

    def __init__(self, n_channels: int, capacity: int):
        self.n_channels = n_channels
        self.capacity = capacity
        self._buf = np.zeros((n_channels, capacity), np.float32)
        self._head = 0    # next write position in the ring
        self._total = 0   # total samples ever pushed

    def push(self, samples: np.ndarray) -> None:
        """Append ``(channels, n)`` samples."""
        samples = np.asarray(samples, np.float32)
        if samples.ndim == 1:
            samples = samples[:, None]
        if samples.shape[0] != self.n_channels:
            raise ValueError(
                f"expected {self.n_channels} channels, got {samples.shape[0]}"
            )
        n = samples.shape[1]
        self._total += n
        if n >= self.capacity:
            self._buf[:] = samples[:, -self.capacity :]
            self._head = 0
            return
        end = self._head + n
        if end <= self.capacity:
            self._buf[:, self._head : end] = samples
        else:
            k = self.capacity - self._head
            self._buf[:, self._head :] = samples[:, :k]
            self._buf[:, : end - self.capacity] = samples[:, k:]
        self._head = end % self.capacity

    @property
    def filled(self) -> int:
        return min(self._total, self.capacity)

    @property
    def total_written(self) -> int:
        return self._total

    def latest(self, n: int) -> np.ndarray:
        """Most recent ``n`` samples, oldest-first, shape (channels, n)."""
        if n > self.filled:
            raise ValueError(f"only {self.filled} samples available")
        start = (self._head - n) % self.capacity
        end = self._head
        if start < end or end == 0:
            if end == 0:
                end = self.capacity
            return self._buf[:, start:end].copy()
        return np.concatenate([self._buf[:, start:], self._buf[:, :end]], axis=1)


class Windower:
    """Emits fixed-length windows every ``hop`` new samples."""

    def __init__(self, ring: RingBuffer, window: int, hop: int):
        self.ring = ring
        self.window = window
        self.hop = hop
        self._next_emit = window

    def poll(self) -> list[np.ndarray]:
        """All windows that became complete since the last poll."""
        out = []
        while self.ring.total_written >= self._next_emit:
            behind = self.ring.total_written - self._next_emit
            if behind + self.window <= self.ring.capacity:
                # reconstruct the window ending at _next_emit
                latest = self.ring.latest(min(self.ring.filled, behind + self.window))
                out.append(latest[:, : self.window])
            self._next_emit += self.hop
        return out


class ThresholdWakeGate:
    """Simple RMS-threshold gate standing in for the wake detector; the real
    gates are ``wake.NativeWakeModel`` / ``wake.WakeMLP`` via ``predict``."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def __call__(self, window: np.ndarray) -> bool:
        return float(np.sqrt(np.mean(np.square(window)))) >= self.threshold


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


class DecodePipeline:
    """wake gate → window batch → decode_fn(windows) → texts.

    ``decode_fn``: (N, C, T) float32 → list[str]; typically the jitted
    frontend+model+beam program wrapped with tokenizer decode.
    """

    def __init__(
        self,
        *,
        windower: Windower,
        decode_fn: Callable[[np.ndarray], Sequence[str]],
        wake_gate: Callable[[np.ndarray], bool] | None = None,
        max_batch: int = 8,
    ):
        self.windower = windower
        self.decode_fn = decode_fn
        self.wake_gate = wake_gate or (lambda w: True)
        self.max_batch = max_batch
        self.latency = LatencyStats()
        self._pending: list[np.ndarray] = []

    def feed(self, samples: np.ndarray) -> list[str]:
        """Push device samples; returns any newly decoded utterances."""
        self.windower.ring.push(samples)
        for w in self.windower.poll():
            if self.wake_gate(w):
                self._pending.append(w)
        out: list[str] = []
        while len(self._pending) >= self.max_batch:
            out.extend(self._flush(self.max_batch))
        return out

    def flush(self) -> list[str]:
        """Decode whatever is pending (end of utterance/stream)."""
        out = []
        while self._pending:
            out.extend(self._flush(min(len(self._pending), self.max_batch)))
        return out

    def _flush(self, n: int) -> list[str]:
        batch = np.stack(self._pending[:n])
        del self._pending[:n]
        t0 = time.perf_counter()
        texts = list(self.decode_fn(batch))
        dt = time.perf_counter() - t0
        for _ in texts:
            self.latency.record(dt / max(len(texts), 1))
        return texts
