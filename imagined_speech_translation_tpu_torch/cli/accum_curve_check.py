"""Loss-curve guard for the default training numerics.

Port of ``tools/accum_curve_check.py``.  Trains the SAME model from the SAME
init on the SAME fixed data under two configurations and compares the loss
curves window by window:

* reference arm: float32 gradient-accumulation carry and float32 first
  moment (``training.grad_accum_dtype=float32``, ``mu_dtype=None``), the
  reference's numerics under bf16 mixed precision;
* fast arm: ``--fast`` (default ``fused,accum_bf16,mu_bf16``): the bfloat16
  carry and the bfloat16 first moment, ``default_config()``'s settings.

The port has one optimizer, the fused clip + AdamW
(``training/optimizer.py``), so both arms run it: ``fused`` changes nothing,
and the report says so (``optimizer``) instead of standing for a third arm.

Data: ``--distinct`` fixed random batches (made on the device from fixed
seeds) cycled for ``--windows`` windows, so the model can fit (the curve
descends) and a numerics regression shows as curve divergence, not noise.
Both arms see the same dropout stream (window ``w`` runs on generator seed
``w``).

Pass criteria (exit 1 on a violation, report JSON written to ``--json``):
per-window relative loss delta |A-B|/A < ``--tol`` (default 2%), the final
window's too, and both curves descend (last < first)::

    python -m imagined_speech_translation_tpu_torch.cli.accum_curve_check \\
        [--micro 4] [--accum 8] [--windows 40] [--distinct 4] [--device cuda]

``--set PATH=VAL`` overrides ``default_config()`` for both arms (a CPU
pilot shrinks the widths).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..config import default_config, replace_nested
from .train import check_device, parse_override

FAST_FLAGS = ("fused", "accum_bf16", "mu_bf16")


def arm_configs(accum: int, fast_flags, overrides=()):
    """``(reference, fast)`` configs: ``default_config()`` under mixed
    precision with ``accum`` micro-steps and ``overrides``; the reference
    with a float32 carry and first moment, the fast arm with ``fast_flags``
    on top of it."""
    base = default_config()
    for expr in overrides:
        base = parse_override(base, expr)
    base = replace_nested(base, "training.mixed_precision", True)
    base = replace_nested(base, "training.grad_accum_steps", accum)
    ref = replace_nested(base, "training.grad_accum_dtype", "float32")
    ref = replace_nested(ref, "training.optimizer.mu_dtype", None)
    unknown = set(fast_flags) - set(FAST_FLAGS)
    if unknown:
        raise ValueError(f"unknown fast flags {sorted(unknown)}; known: {FAST_FLAGS}")
    fast = ref
    if "fused" in fast_flags:
        fast = replace_nested(fast, "training.optimizer.fused", True)
    if "accum_bf16" in fast_flags:
        fast = replace_nested(fast, "training.grad_accum_dtype", "bfloat16")
    if "mu_bf16" in fast_flags:
        fast = replace_nested(fast, "training.optimizer.mu_dtype", "bfloat16")
    return ref.validate(), fast.validate()


def fixed_batches(cfg, micro: int, distinct: int, device) -> list[dict]:
    """``distinct`` windows ``(accum, micro, ...)`` made on ``device`` from
    seeds 100, 101, ...: normal EEG on the configured region channels, ids
    below ``min(1000, vocab)`` that are also the labels."""
    accum, T, L = cfg.training.grad_accum_steps, cfg.data.n_timepoints, cfg.data.max_length
    mask = torch.zeros(4, 16, dtype=torch.bool)
    for r, c in enumerate(cfg.model.region_channel_counts):
        mask[r, :c] = True
    mask = mask.to(device)
    high = min(1000, cfg.model.bart.vocab_size)
    out = []
    for i in range(distinct):
        g = torch.Generator(device).manual_seed(100 + i)
        ids = torch.randint(0, high, (accum, micro, L), generator=g, device=device)
        out.append({
            "eeg": torch.randn((accum, micro, 4, 16, T), generator=g, device=device),
            "decoder_input_ids": ids,
            "labels": ids,  # learnable: predict the (shifted) input stream
            "attention_mask": torch.ones_like(ids),
            "channel_mask": mask,
        })
    return out


def run_arm(cfg, args, label: str, device) -> tuple[list[float], float]:
    """The loss of each of ``args.windows`` optimizer steps of ``cfg`` from
    the seed-0 init, and their seconds."""
    import numpy as np

    from ..training import (
        AdaptiveLossScheduler,
        FusedAdamW,
        build_train_module,
        create_train_state,
        make_train_step,
    )

    bow_k = cfg.training.loss.bow_vocab_size
    module = build_train_module(cfg, bow_k, seed=0, device=device)
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     args.windows)
    state = create_train_state(module, opt,
                               AdaptiveLossScheduler(cfg.training.loss).initial_weights())
    bow = np.random.default_rng(0).integers(0, cfg.model.bart.vocab_size, bow_k).tolist()
    step = make_train_step(module, opt, cfg, bow)
    batches = fixed_batches(cfg, args.micro, args.distinct, device)
    losses = []
    t0 = time.perf_counter()
    for w in range(args.windows):
        state, metrics = step(state, batches[w % args.distinct], torch.Generator().manual_seed(w))
        losses.append(float(metrics["loss"]))
    seconds = time.perf_counter() - t0
    print(f"[{label}] {args.windows} windows in {seconds:.1f}s  "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return losses, seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--distinct", type=int, default=4)
    ap.add_argument("--tol", type=float, default=0.02)
    ap.add_argument("--json", default="runs/torch_train_profile/accum_curve.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(
        "--fast",
        default="fused,accum_bf16,mu_bf16",
        help="comma list of fast-arm flags (fused, accum_bf16, mu_bf16)",
    )
    ap.add_argument("--set", action="append", dest="overrides", default=[],
                    metavar="PATH=VAL", help="overrides of default_config() for both arms")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    flags = {f.strip() for f in args.fast.split(",") if f.strip()}
    ref_cfg, fast_cfg = arm_configs(args.accum, flags, args.overrides)
    ref_cfg = replace_nested(ref_cfg, "training.batch_size", args.micro)
    fast_cfg = replace_nested(fast_cfg, "training.batch_size", args.micro)
    print("device:", device, torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu", flush=True)

    ref_losses, ref_s = run_arm(ref_cfg, args, "reference-numerics", device)
    fast_losses, fast_s = run_arm(fast_cfg, args, "fast-numerics", device)

    rel = [abs(a - b) / max(abs(a), 1e-9)
           for a, b in zip(ref_losses, fast_losses)]

    def numerics(cfg):
        t = cfg.training
        return {"grad_accum_dtype": t.grad_accum_dtype,
                "mu_dtype": t.optimizer.mu_dtype or "float32"}

    report = {
        "windows": args.windows,
        "distinct_batches": args.distinct,
        "micro": args.micro,
        "accum": args.accum,
        "fast_flags": sorted(flags),
        "reference_numerics": numerics(ref_cfg),
        "fast_numerics": numerics(fast_cfg),
        "optimizer": "fused clip + AdamW in both arms (the port's only optimizer)",
        "ref_first_last": [ref_losses[0], ref_losses[-1]],
        "fast_first_last": [fast_losses[0], fast_losses[-1]],
        "max_rel_delta": max(rel),
        "final_rel_delta": rel[-1],
        "tol": args.tol,
        "seconds": {"reference": ref_s, "fast": fast_s},
        "ref_losses": [round(v, 5) for v in ref_losses],
        "fast_losses": [round(v, 5) for v in fast_losses],
    }
    ok = (
        max(rel) < args.tol
        and ref_losses[-1] < ref_losses[0]
        and fast_losses[-1] < fast_losses[0]
    )
    report["ok"] = ok
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items()
                      if not k.endswith("losses")}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
