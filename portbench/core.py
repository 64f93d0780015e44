"""The two records a traffic driver shares with ``portbench.run``."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Run:
    """What a traffic driver is handed."""

    cell: dict
    config: dict  # the configuration file
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    start: float = field(default_factory=time.time)

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    """What a traffic driver returns."""

    attempted: int
    failed: int
    metrics: dict  # end-to-end metric -> value (with --trace 0)
    checks: list  # (name, value, limit): correct needs value <= limit
    memory_peak_bytes: int
    layer: dict = field(default_factory=dict)  # what the per-layer readers read
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None



def load() -> tuple[float, float]:
    """Wall and process CPU seconds now, for :func:`host_report`."""
    return time.perf_counter(), time.process_time()


def host_report(before: tuple[float, float]) -> str:
    """The process's CPU seconds over the wall seconds since ``before``.
    The cells are paced by one host thread: at a fixed amount of work, more
    CPU seconds an item mean a slower core, not more work."""
    wall, cpu = (b - a for a, b in zip(before, load()))
    return f"host: {cpu:.2f} CPU s of {wall:.2f} s"
