"""What the serving cells share: the decode function and its window pool,
the reference's judgement of served ids, and the per-layer readers'
inputs."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import flops, inputs, program
from portbench import trace as tr
from portbench.reference.judge import serve_gaps


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(run, n: int):
    """The decode function and a pool of ``n`` windows of the run's seed."""
    t = run.traffic
    cfg = program.config(run.config["config"], {"generation.min_length": t["decode_length"],
                                                "generation.max_length": t["decode_length"]})
    dtype = getattr(torch, t["compute_dtype"])
    decode_fn, tok, labels, wspec = program.serving(cfg, run.seed, run.device, dtype,
                                                    t["n_channels"])
    pool = inputs.windows(run.seed, n, t["n_channels"], cfg.data.n_timepoints,
                          run.device).cpu().numpy()
    return cfg, decode_fn, tok, labels, wspec, pool


def judge(run, cfg, labels, wspec, raw, ids) -> list:
    """The reference's checks of served ``ids`` for ``raw`` windows, run
    after the program's state is freed."""
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    w = inputs.weights(wspec, run.seed, run.device)
    gather, mask = inputs.region_gather(labels, cfg.model.max_region_channels)
    eos = inputs.vocab(cfg.model.bart.vocab_size).index("[SEP]")
    t0 = time.perf_counter()
    gaps = serve_gaps(run.config["config"], w, raw, ids, gather, mask, eos=eos,
                      beams=cfg.generation.num_beams, device=run.device)
    run.log(f"reference: {len(raw)} windows in {time.perf_counter() - t0:.1f} s; beam gaps "
            f"median {np.median(gaps):.4g}, max {gaps.max():.4g} nats; "
            f"{(gaps > 0).mean():.4%} of {gaps.size} served tokens below the third best")
    return [("beam_gap", float(gaps.max()), run.limits.get("beam_gap", float("nan")))]


def layer_reading(run, cfg, events, windows: int, batches: int, batch: int) -> dict:
    """What the serving per-layer readers read, for ``batches`` calls of
    ``batch`` rows that served ``windows`` windows."""
    t = run.traffic
    tree = run.config["config"]
    return dict(
        events=events, summary=tr.device_summary(events), windows=windows, batches=batches,
        dtype=t["compute_dtype"], elem=torch.empty((), dtype=getattr(torch, t["compute_dtype"]))
        .element_size(),
        flops_per_window=flops.serve_window_flops(tree, cfg.generation.num_beams,
                                                  t["decode_length"] - 1),
        flash_calls=flops.flash_calls(tree, batch) * batches,
        iir_rows=batch * t["n_channels"] * batches, length=cfg.data.n_timepoints,
    )
