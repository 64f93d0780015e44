"""Training steps back to back through the port's default training step
(``training.make_train_step``: micro-batches accumulated, composite loss,
clipped fused AdamW, mixed precision as the configuration states).

The configuration's ``training`` section gives the micro-batch and the
accumulation steps.  Parameters (the traffic file): a pool of ``pool_steps``
distinct window batches made from the seed and cycled, ``label_length``
tokens a window, the schedule's ``total_steps``, the ``follow_steps`` that
set-up runs and the reference follows, and ``trace_steps`` for a traced run.

Set-up builds the one train state and drives it through the first
``follow_steps`` steps with the window's own call and feed; it reads each
step's loss components, the first gradient as the optimizer took it (from
the second moment after one step: ``nu = (1 - b2) g^2``) and, before the
next step, every parameter's change.  The window then goes on with the same
state.  A traced run times ``trace_steps`` steps untraced, then traces as
many.  End-to-end: ``train_windows_per_s`` is every window of every step
completed in the window over the window's seconds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import flops, inputs, program
from portbench import trace as tr
from portbench.core import Outcome, host_report, load
from portbench.reference.judge import leaf_gap
from portbench.reference.train import COMPONENTS, follow
from portbench.serving import sync


def step_seed(seed: int, k: int) -> int:
    return (int(seed) * 131 + k) % 2**62


def region_mask(cfg) -> np.ndarray:
    counts = cfg.model.region_channel_counts
    mask = np.zeros((len(counts), cfg.model.max_region_channels), bool)
    for r, n in enumerate(counts):
        mask[r, :n] = True
    return mask


def run(run):
    t, dev = run.traffic, run.device
    cfg = program.config(run.config["config"])
    tc = cfg.training
    accum, b = tc.grad_accum_steps, tc.batch_size
    state, step_fn, bow, wspec = program.training(cfg, run.seed, dev, t["total_steps"])
    pool = inputs.train_batches(run.seed, t["pool_steps"], accum, b, region_mask(cfg),
                                cfg.data.n_timepoints, t["label_length"],
                                cfg.model.bart.vocab_size, dev)

    def step(k):
        return step_fn(state, pool[k % len(pool)], torch.Generator().manual_seed(
            step_seed(run.seed, k)))[1]

    # the first steps, read for the reference; they also load the kernels
    w0 = inputs.weights(wspec, run.seed, dev)
    b2 = tc.optimizer.adam_b2
    losses, grad_norms = [], {}
    for k in range(t["follow_steps"]):
        m = step(k)
        losses.append({c: float(m[f"loss_{c}"]) for c in COMPONENTS} | {"loss": float(m["loss"])})
        if k == 0:
            grad_norms = {n: float(torch.sqrt(v.sum() / (1.0 - b2)))
                          for n, v in state.opt_state.nu.items()}
    with torch.no_grad():
        change_norms = {n: float(torch.linalg.vector_norm(p - w0[n]))
                        for n, p in state.module.named_parameters()}
    del w0
    sync(dev)
    setup_s = time.time() - run.start
    run.log(f"set-up {setup_s:.2f} s (with {t['follow_steps']} steps)")

    done, layer, metrics = t["follow_steps"], {}, {}
    busy = window = breakdown = None
    if run.trace:
        # as many steps untraced first: the profiler's host cost slows the
        # host-paced step, so rates come from this stretch
        steps = t["trace_steps"]
        t0 = time.perf_counter()
        for k in range(done, done + steps):
            step(k)
        sync(dev)
        untraced_s = time.perf_counter() - t0
        done += steps

        def block():
            for k in range(done, done + steps):
                with torch.profiler.record_function("portbench.train_step"):
                    step(k)

        events = tr.traced(block, dev)
        dtype = "bfloat16" if tc.mixed_precision else "float32"
        tree = run.config["config"]
        layer = dict(events=events, summary=tr.device_summary(events), steps=steps,
                     dtype=dtype, elem=2 if tc.mixed_precision else 4,
                     flops_per_step=flops.train_step_flops(tree, accum, b, t["label_length"],
                                                           len(bow)),
                     flash_bwd_calls=flops.flash_calls(tree, b) * accum * steps,
                     untraced_s=untraced_s)
        busy, window = tr.busy_and_span(layer["summary"])
        breakdown = tr.breakdown(events, layer["summary"])
        run.log(f"{steps} steps in {untraced_s:.3f} s untraced; traced: span {window} s, "
                f"the card busy {busy} s")
    else:
        host = load()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            step(done + n)
            n += 1
        sync(dev)
        elapsed = time.perf_counter() - t0
        rate = n * accum * b / elapsed
        metrics = {"train_windows_per_s": rate, "setup_s": setup_s}
        run.log(f"{n} steps of {accum * b} windows in {elapsed:.3f} s: {rate:.3f} windows/s; "
                f"{host_report(host)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    attempted = (done + (n if not run.trace else steps)) * accum * b

    follow_batches = [pool[k % len(pool)] for k in range(t["follow_steps"])]
    del state, step_fn, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(run, cfg, wspec, bow, follow_batches, losses, grad_norms, change_norms)
    return Outcome(attempted=attempted, failed=0, metrics=metrics, checks=checks,
                   memory_peak_bytes=peak, layer=layer, busy_s=busy, window_s=window,
                   breakdown=breakdown)


def judge(run, cfg, wspec, bow, batches, losses, grad_norms, change_norms) -> list:
    """The reference follows the first steps; the worst gaps, each beside
    its limit."""
    t0 = time.perf_counter()
    w0 = inputs.weights(wspec, run.seed, run.device)
    ref = follow(run.config["config"], w0, batches,
                 [step_seed(run.seed, k) for k in range(len(batches))], bow,
                 operand_bytes=2 if cfg.training.mixed_precision else 4)
    loss_gap = max(abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(losses, ref["losses"])
                   for k in r)
    med = float(np.median(list(ref["grad_norms"].values())))
    keep = {n for n, v in ref["grad_norms"].items() if v >= 1e-3 * med}
    grad_gap, grad_leaf, n_leaves, grad_median = leaf_gap(grad_norms, ref["grad_norms"],
                                                          keep.__contains__)
    change_gap, change_leaf, _, change_median = leaf_gap(change_norms, ref["change_norms"],
                                                         keep.__contains__)
    run.log(f"reference: {len(batches)} steps in {time.perf_counter() - t0:.1f} s; "
            f"losses program {[round(x['loss'], 6) for x in losses]} reference "
            f"{[round(x['loss'], 6) for x in ref['losses']]}; {n_leaves} of "
            f"{len(ref['grad_norms'])} leaves compared; worst gradient {grad_leaf}, "
            f"worst change {change_leaf}")
    lim = run.limits
    nan = float("nan")
    return [("loss_gap", loss_gap, lim.get("loss_gap", nan)),
            ("grad_gap", grad_gap, lim.get("grad_gap", nan)),
            ("change_gap", change_gap, lim.get("change_gap", nan)),
            ("grad_median_gap", grad_median, lim.get("grad_median_gap", nan)),
            ("change_median_gap", change_median, lim.get("change_median_gap", nan))]
