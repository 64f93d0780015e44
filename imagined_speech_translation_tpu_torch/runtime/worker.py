"""Recycling decode worker: bound the serving process's memory.

A serving process that owns the device can grow in resident memory over
its lifetime (a device library, a transport or an allocator that keeps what
each host-to-device transfer touched), and a device runtime cannot be
re-created inside one process.  This module bounds that structurally: the decode
function (and therefore the device context) lives in a CHILD process; the
server proxies decode calls over a pipe and RECYCLES the child when its RSS
crosses a budget.  The server process never touches the device, so its RSS
stays flat; the child's RSS is sawtooth-bounded by the budget.  Costs per
recycle: one child start plus the decode function's build and warm-up.
Budgets are sized so recycles are minutes apart, and the single-dispatcher
batch scheduler (``runtime/batcher.py``) simply queues during the gap.

The callable is ``decode_fn``-compatible (``(N, C, T) float32 -> list[str]``)
so it drops into ``BatchScheduler`` / ``DecodePipeline`` unchanged.

Usage::

    worker = DecodeWorker(factory, rss_budget_mb=4096)  # factory: () -> decode_fn
    worker.start()                  # spawns + runs factory (builds/warms)
    texts = worker(batch)           # proxied decode
    worker.stats()                  # {"recycles": ..., "child_rss_mb": ...}
    worker.stop()

``factory`` must be picklable (a module-level function or
``functools.partial`` of one, e.g. of ``cli.serve.build_decode_fn_from_args``)
-- it runs inside the spawned child, builds the decode function (claiming
the device THERE), and warms it.  The start method is ``spawn``: CUDA does
not survive a fork.  A factory that fails raises ``RuntimeError`` in the
parent.

Reference counterpart: none -- the reference's serving plane respawns whole
Node cluster workers on crash (``wss/wss.js:96-98``) but has no memory
governance; this is that supervision pattern applied proactively.

A copy of ``imagined_speech_translation_tpu.runtime.worker`` (the port
imports nothing of the JAX package); ``tests/test_torch_worker.py`` holds
the copy to the original.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import threading
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _rss_mb(pid: int) -> float:
    try:
        for line in Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def _child_main(conn, factory) -> None:
    """Child body: build + warm the decode fn, then serve the pipe."""
    try:
        decode_fn = factory()
        conn.send(("ready", None))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        conn.send(("fatal", f"{type(e).__name__}: {e}"))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg[0] == "stop":
            conn.send(("bye", None))
            return
        _, shape, dtype, buf = msg
        try:
            batch = np.frombuffer(buf, dtype=dtype).reshape(shape)
            conn.send(("ok", list(decode_fn(batch))))
        except Exception as e:  # noqa: BLE001 - the call fails, not the loop
            conn.send(("err", f"{type(e).__name__}: {e}"))


class DecodeWorker:
    """``decode_fn``-compatible proxy to a recycled child process."""

    def __init__(
        self,
        factory: Callable[[], Callable[[np.ndarray], Sequence[str]]],
        *,
        rss_budget_mb: float = 8192.0,
        check_every: int = 8,
        start_timeout_s: float = 600.0,
    ):
        if rss_budget_mb <= 0:
            raise ValueError("rss_budget_mb must be > 0")
        self.factory = factory
        self.rss_budget_mb = rss_budget_mb
        self.check_every = max(1, check_every)
        self.start_timeout_s = start_timeout_s
        self.recycles = 0
        self.calls = 0
        self._ctx = mp.get_context("spawn")  # fork is unsafe after CUDA init
        self._lock = threading.Lock()
        self._proc = None
        self._conn = None
        self._last_rss = float("nan")

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            self._start_locked()

    def _start_locked(self) -> None:
        if self._proc is not None:
            return
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_child_main, args=(child, self.factory), daemon=True
        )
        t0 = time.monotonic()
        proc.start()
        child.close()
        if not parent.poll(self.start_timeout_s):
            proc.kill()
            raise RuntimeError(
                f"decode worker did not come up in {self.start_timeout_s}s"
            )
        try:
            status, payload = parent.recv()
        except EOFError:
            proc.join(5.0)
            raise RuntimeError(
                "decode worker died during startup (factory must be a "
                "picklable module-level callable; __main__ must be a real "
                f"file under the spawn start method); rc={proc.exitcode}"
            ) from None
        if status != "ready":
            proc.join(5.0)
            raise RuntimeError(f"decode worker failed to build: {payload}")
        self._proc, self._conn = proc, parent
        logger.info(
            "decode worker pid=%d ready in %.1fs (rss budget %.0f MB)",
            proc.pid, time.monotonic() - t0, self.rss_budget_mb,
        )

    def stop(self) -> None:
        with self._lock:
            self._stop_locked()

    def _stop_locked(self) -> None:
        proc, conn = self._proc, self._conn
        self._proc = self._conn = None
        if proc is None:
            return
        try:
            conn.send(("stop",))
            conn.poll(10.0)
        except (OSError, BrokenPipeError):
            pass
        conn.close()
        proc.join(15.0)
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- decode_fn surface -----------------------------------------------
    def __call__(self, batch: np.ndarray) -> list[str]:
        batch = np.ascontiguousarray(batch)
        with self._lock:
            if self._proc is None:
                self._start_locked()
            try:
                self._conn.send(
                    ("decode", batch.shape, str(batch.dtype), batch.tobytes())
                )
                status, payload = self._conn.recv()
            except (EOFError, OSError, BrokenPipeError) as e:
                # child died mid-call: recycle so the NEXT call works, fail
                # this one (the batcher isolates per-batch failures)
                logger.error("decode worker died (%s); recycling", e)
                self._stop_locked()
                self.recycles += 1
                raise RuntimeError("decode worker crashed") from e
            if status == "err":
                raise RuntimeError(f"decode worker: {payload}")
            self.calls += 1
            if self.calls % self.check_every == 0:
                self._last_rss = _rss_mb(self._proc.pid)
                if self._last_rss > self.rss_budget_mb:
                    logger.info(
                        "decode worker rss %.0f MB > budget %.0f MB: recycling",
                        self._last_rss, self.rss_budget_mb,
                    )
                    self._stop_locked()
                    self.recycles += 1
                    # respawn NOW so the recycle cost is paid here, inside
                    # the dispatcher thread, not split across later calls
                    self._start_locked()
            return list(payload)

    # -- telemetry -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "recycles": self.recycles,
            "calls": self.calls,
            "child_pid": self._proc.pid if self._proc else None,
            "child_rss_mb": (
                round(self._last_rss, 1)
                if self._last_rss == self._last_rss
                else None
            ),
            "rss_budget_mb": self.rss_budget_mb,
        }
