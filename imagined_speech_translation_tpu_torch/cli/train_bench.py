"""Training-step throughput at the reference's full size on one CUDA card.

Port of ``tools/tpu_train_bench.py``.  It runs one full gradient-
accumulation window (micro-batch 4 x accumulation 8 = 32 windows, T = 1651,
composite loss) through ``training.make_train_step``, the step ``cli.train``
runs, in float32 and in bf16 mixed precision, and reports per mode the
window's milliseconds and samples/s (the mean over ``--iters`` steps after
the first, which builds the kernels and is reported as ``compile_s``) and the
last step's loss.  The state updates in place from step to step, as in
training.  Beside the wall time each mode gives the busy device milliseconds
and kernel launches of one more, profiled step (``device_ms``,
``launches``), the port's own kernel launches by name in it
(``kernel_launches``) and the peak device memory.

    python -m imagined_speech_translation_tpu_torch.cli.train_bench \\
        [--micro 4] [--accum 8] [--iters 5] [--modes fp32,bf16] \\
        [--accum-dtype float32|bfloat16] [--mu-dtype bfloat16] [--device cuda|cpu]

``--rng-impl`` and ``--fused`` are accepted for the JAX tool's command
lines and change nothing: the port's dropout stream has one implementation
(the config's ``training.rng_impl`` has no effect in the port either), and
both optimizer settings are the port's one fused AdamW.  Random weights from
seed 0 and a synthetic window made with numpy.  The report is printed as
JSON and written to ``runs/torch_profile/train_bench.json``; the first
printed line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..config import Config, default_config, replace_nested
from ..training import make_train_step
from .profile_slice import (
    open_device,
    peak_memory_gib,
    profiled_run,
    reset_peak_memory,
    sync,
    write_report,
)
from .train_profile import build_step

DEFAULT_OUT = Path("runs/torch_profile/train_bench.json")


def mode_config(mode: str, micro: int, accum: int, *, accum_dtype: str | None = None,
                mu_dtype: str | None = None, cfg: Config | None = None) -> Config:
    """``cfg`` (``default_config()``) for ``mode`` (``fp32`` or ``bf16``,
    mixed precision) at micro-batch ``micro`` x ``accum``."""
    if mode not in ("fp32", "bf16"):
        raise ValueError(f"mode {mode!r}: fp32 or bf16")
    cfg = replace_nested(cfg or default_config(), "training.mixed_precision", mode == "bf16")
    cfg = replace_nested(cfg, "training.grad_accum_steps", accum)
    cfg = replace_nested(cfg, "training.batch_size", micro)
    if accum_dtype:
        cfg = replace_nested(cfg, "training.grad_accum_dtype", accum_dtype)
    if mu_dtype:
        cfg = replace_nested(cfg, "training.optimizer.mu_dtype", mu_dtype)
    return cfg


def bench_mode(cfg: Config, device, iters: int) -> dict:
    """One mode's row: the first step's seconds, then ``iters`` steps."""
    device = torch.device(device)
    reset_peak_memory(device)
    state, opt, bow, batch = build_step(cfg, device)
    step = make_train_step(state.module, opt, cfg, bow)

    def one():
        return step(state, batch, torch.Generator().manual_seed(state.step))[1]

    sync(device)
    t0 = time.perf_counter()
    one()
    sync(device)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = one()
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    prof = profiled_run(one, device)
    n = cfg.training.grad_accum_steps * cfg.training.batch_size
    return dict(window_ms=dt * 1e3, samples_per_sec=n / dt, compile_s=compile_s,
                loss=float(metrics["loss"]), **prof, peak_memory_gib=peak_memory_gib(device))


def main(argv=None, *, cfg: Config | None = None) -> int:
    """The CLI; ``cfg`` replaces ``default_config()`` (the tests' tiny one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--modes", default="fp32,bf16")
    ap.add_argument("--rng-impl", default=None,
                    help="accepted for the JAX tool's command lines; no effect in the port "
                    "(one dropout stream implementation)")
    ap.add_argument("--accum-dtype", default=None,
                    help="grad accumulation carry dtype under bf16 (float32/bfloat16)")
    ap.add_argument("--fused", action="store_true",
                    help="accepted for the JAX tool's command lines; the port's AdamW is "
                    "always the fused one")
    ap.add_argument("--mu-dtype", default=None,
                    help="first-moment storage dtype (bfloat16 halves m-state traffic)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device, smi = open_device(args.device)
    report = {}
    for mode in args.modes.split(","):
        row = bench_mode(mode_config(mode, args.micro, args.accum, accum_dtype=args.accum_dtype,
                                     mu_dtype=args.mu_dtype, cfg=cfg), device, args.iters)
        report[mode] = row
        print(f"[{mode}] window {row['window_ms']:8.1f} ms  {row['samples_per_sec']:6.1f} "
              f"samples/s  (compile {row['compile_s']:.0f}s, loss {row['loss']:.3f})", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    report["card"] = smi
    write_report(report, DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
