"""The traced run's reading: a profiler trace of a block, checked whole, and
what the per-layer metrics and the breakdown read from it.

:func:`traced` is a frozen copy of the port's ``utils.profiling.trace``
(sentinel kernels open the session, the block runs inside an annotation,
the trace is refused when a launch of the block lost its device record)
and :func:`device_summary` of ``cli.profile_slice.device_summary`` (busy
time is the union of kernel, copy and memset intervals; idle is the rest of
the span), kept here so that a change to the port cannot move the
yardstick."""

from __future__ import annotations

import contextlib
import heapq
import json
import tempfile
from collections import defaultdict
from pathlib import Path

import torch

SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel, which no program launches
SENTINELS = 256
BLOCK = "portbench.traced_block"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class IncompleteTrace(RuntimeError):
    """A launch of the block has no device record in the trace."""


def _is_launch(e: dict) -> bool:
    return e.get("cat") in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in e.get("name", "")


def block_events(events: list[dict]) -> list[dict]:
    """The events from the block's annotation on, without the sentinels."""
    start = min(e["ts"] for e in events if e.get("name") == BLOCK and "ts" in e)
    return [e for e in events if e.get("ph") != "M" and "ts" in e
            and float(e["ts"]) >= start and SENTINEL not in e.get("name", "")]


def check_whole(events: list[dict]) -> None:
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not any(SENTINEL in e.get("name", "") for e in kernels):
        raise IncompleteTrace("the trace lacks the sentinel kernels")
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    launches = [e for e in block_events(events) if _is_launch(e)]
    missing = [e for e in launches if e.get("args", {}).get("correlation") not in recorded]
    if missing:
        raise IncompleteTrace(f"{len(missing)} of {len(launches)} launches have no device record")


@contextlib.contextmanager
def _session(out: list, cuda: bool):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        with torch.profiler.profile(activities=activities) as prof:
            if cuda:
                for _ in range(SENTINELS):
                    torch.cuda._sleep(100)
                torch.cuda.synchronize()
            with torch.profiler.record_function(BLOCK):
                yield
                if cuda:
                    torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    if cuda:
        check_whole(events)
    out.extend(block_events(events))


def traced(fn, device, attempts: int = 3) -> list[dict]:
    """Run ``fn()`` under the profiler and return the block's events; on a
    card, a trace that lost device records is taken again (the whole
    ``fn``).  On the CPU (the tests) the trace holds host events alone."""
    for attempt in range(attempts):
        events: list[dict] = []
        try:
            with _session(events, device.type == "cuda"):
                fn()
            return events
        except IncompleteTrace:
            if attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")


def device_summary(events: list[dict]) -> dict | None:
    """Span (first event to last), device busy seconds (the union of the
    device intervals), kernel launches and device seconds by kernel name;
    ``None`` for a trace without device activity (a CPU run)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE]
    if not device:
        return None
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e["dur"] for e in spans)
    busy, intervals = 0.0, []
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = float(e["ts"]), float(e["ts"] + e["dur"])
        if intervals and lo <= intervals[-1][1]:
            intervals[-1][1] = max(intervals[-1][1], hi)
        else:
            intervals.append([lo, hi])
    busy = sum(hi - lo for lo, hi in intervals)
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e["name"]] += e["dur"] / 1e6
    return dict(start=start, end=end, span_s=(end - start) / 1e6, busy_s=busy / 1e6,
                launches=sum(e.get("cat") == "kernel" for e in device),
                by_name=dict(by_name), intervals=intervals)


def busy_and_span(summary: dict | None) -> tuple[float | None, float | None]:
    """The device's busy seconds and the traced window's seconds."""
    return (None, None) if summary is None else (summary["busy_s"], summary["span_s"])


def kernel_seconds(summary: dict, match) -> float:
    """Device seconds of the kernels whose name ``match(name)`` accepts."""
    return sum(s for n, s in summary["by_name"].items() if match(n))


def idle_by_host(events: list[dict], summary: dict, top: int = 10) -> list[list]:
    """Device idle seconds within the span, grouped by the innermost host
    span open at each gap's middle (the benchmark's spans, ``aten::`` ops,
    CUDA runtime calls), largest first."""
    gaps, prev = [], summary["start"]
    for lo, hi in summary["intervals"]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    if summary["end"] > prev:
        gaps.append((prev, summary["end"]))
    host = sorted((float(e["ts"]), float(e["ts"] + e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST and "dur" in e)
    totals: dict[str, float] = defaultdict(float)
    active: list = []  # max-heap on start: the innermost open span on top
    i = 0
    for lo, hi in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (lo + hi) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        # spans are taken in order of start and gaps in order of time, so a
        # span that has ended is over for every later gap too
        while active and active[0][1] <= mid:
            heapq.heappop(active)
        totals[active[0][2] if active else "(no host span)"] += (hi - lo) / 1e6
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(events: list[dict], summary: dict | None) -> dict | None:
    if summary is None:
        return None
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in idle_by_host(events, summary)]}
