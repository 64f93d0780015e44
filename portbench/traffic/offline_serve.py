"""Offline serving: batches of distinct raw windows back to back through the
port's serving decode function (``cli.serve.build_decode_fn``), as a bulk
re-decode of recorded sessions runs it.

Parameters (the traffic file): ``batch`` windows a call, a pool of
``pool_batches`` distinct batches made from the seed and cycled,
``n_channels`` raw montage channels a window, ``decode_length`` (the
generation's minimum and maximum length, pinned so that every window does
the same work), ``compute_dtype``, ``trace_batches`` for a traced run and
``check_windows``, the served windows the reference judges.  A traced run
decodes ``trace_batches`` batches untraced, then traces as many.

End-to-end: ``windows_per_s`` is every window decoded in the window over
the window's seconds (the last call is the one that crosses the end).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import trace as tr
from portbench.core import Outcome, host_report, load
from portbench.serving import build, judge, layer_reading, sync


def run(run):
    t, dev = run.traffic, run.device
    b, p = t["batch"], t["pool_batches"]
    cfg, decode_fn, tok, labels, wspec, pool = build(run, b * p)
    batches = [pool[i * b: (i + 1) * b] for i in range(p)]
    decode_fn(batches[0])  # the cell's one shape: loads (or builds) the kernels
    sync(dev)
    setup_s = time.time() - run.start
    run.log(f"set-up {setup_s:.2f} s")

    failed, layer, metrics = 0, {}, {}
    busy = window = breakdown = None
    tok.record.clear()
    if run.trace:
        # the same batches untraced first: the profiler's host cost slows
        # the host-paced decode, so rates come from this stretch
        t0 = time.perf_counter()
        for i in range(t["trace_batches"]):
            decode_fn(batches[i % p])
        untraced_s = time.perf_counter() - t0

        def block():
            for i in range(t["trace_batches"]):
                with torch.profiler.record_function("portbench.decode_batch"):
                    decode_fn(batches[i % p])

        events = tr.traced(block, dev)
        layer = layer_reading(run, cfg, events, t["trace_batches"] * b, t["trace_batches"], b)
        layer["untraced_s"] = untraced_s
        busy, window = tr.busy_and_span(layer["summary"])
        breakdown = tr.breakdown(events, layer["summary"])
        run.log(f"{t['trace_batches']} batches in {untraced_s:.3f} s untraced; traced: "
                f"span {window} s, the card busy {busy} s")
    else:
        host = load()
        n, t0 = 0, time.perf_counter()
        while True:
            texts = decode_fn(batches[n % p])
            failed += b - len(texts)
            n += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        elapsed = time.perf_counter() - t0
        metrics = {"windows_per_s": n * b / elapsed, "setup_s": setup_s}
        run.log(f"{n} batches of {b} in {elapsed:.3f} s: {n * b / elapsed:.3f} windows/s; "
                f"{host_report(host)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    served = tok.record
    attempted = len(served) * b
    pick = np.random.default_rng(run.seed).choice(attempted, size=min(t["check_windows"],
                                                                      attempted), replace=False)
    raw = pool[[(k // b % p) * b + k % b for k in pick]]
    ids = np.stack([served[k // b][k % b] for k in pick])
    del decode_fn, batches, served
    tok.record = []
    checks = judge(run, cfg, labels, wspec, raw, ids)
    return Outcome(attempted=attempted, failed=failed, metrics=metrics, checks=checks,
                   memory_peak_bytes=peak, layer=layer, busy_s=busy, window_s=window,
                   breakdown=breakdown)
