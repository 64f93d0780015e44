"""Readings for the limits of ``correct``, on the card at a cell's own size.

    python -m portbench.control --workload <cell> --seeds 1,2,3 --what program
    python -m portbench.control --workload <cell> --seeds 1,2,3 --what control
    python -m portbench.control --workload <cell> --seeds 1,2,3 --what fault:<name>

``program``: the cell's set-up, one batch (serving) or none past the
followed steps (training), and the reference's comparison, on each seed in
one process: the sound runs' readings, the lower end of each limit.
``control``: the reference in float8 in the program's place, on the same
inputs and served prefixes: the upper end.  ``fault:<name>``: the program
with a fault of :mod:`portbench.faults` planted.  One JSON line a seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import inputs, serving
from portbench import run as bench
from portbench.core import Run
from portbench.faults import FAULTS
from portbench.reference.judge import leaf_gap, serve_gaps
from portbench.reference.model import Precision
from portbench.reference.train import COMPONENTS, follow


def cell_run(workload: str, seed: int, device) -> Run:
    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    cell = bench.find(b, "workloads", workload)
    conf = bench.find(b, "configs", cell["config"])
    traffic = json.loads((bench.ROOT / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    return Run(cell=cell, config=json.loads((bench.ROOT / conf["file"]).read_text()),
               traffic=traffic, limits={}, seed=seed, seconds=0, trace=False, device=device)


def serve_control(run: Run) -> dict:
    """The served prefixes of one batch, judged against the float32
    reference with the served tokens and with the float8 reference's."""
    n = run.traffic["check_windows"]
    cfg, decode_fn, tok, labels, wspec, raw = serving.build(run, n)
    decode_fn(raw)
    ids = tok.record[-1]
    del decode_fn
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    w = inputs.weights(wspec, run.seed, run.device)
    gather, mask = inputs.region_gather(labels, cfg.model.max_region_channels)
    kw = dict(eos=inputs.vocab(cfg.model.bart.vocab_size).index("[SEP]"),
              beams=cfg.generation.num_beams, device=run.device)
    prog = serve_gaps(run.config["config"], w, raw, ids, gather, mask, **kw)
    ctrl = serve_gaps(run.config["config"], w, raw, ids, gather, mask, control=True, **kw)
    return {"program_beam_gap": float(prog.max()), "control_beam_gap": float(ctrl.max()),
            "program_beam_out_share": float((prog > 0).mean()),
            "control_beam_out_share": float((ctrl > 0).mean()),
            "program_window_gaps": [float(g) for g in prog.max(axis=1)],
            "control_window_gaps": [float(g) for g in ctrl.max(axis=1)]}


def train_control(run: Run) -> dict:
    """The float8 reference in the program's place over the followed steps,
    judged as the program is."""
    drv = bench.load_py(bench.ROOT / "portbench/traffic/train_steps.py", "train_steps")
    from portbench import program

    t = run.traffic
    cfg = program.config(run.config["config"])
    tc = cfg.training
    state, _, bow, wspec = program.training(cfg, run.seed, run.device, t["total_steps"])
    del state
    pool = inputs.train_batches(run.seed, t["follow_steps"], tc.grad_accum_steps, tc.batch_size,
                                drv.region_mask(cfg), cfg.data.n_timepoints, t["label_length"],
                                cfg.model.bart.vocab_size, run.device)
    seeds = [drv.step_seed(run.seed, k) for k in range(t["follow_steps"])]
    w0 = inputs.weights(wspec, run.seed, run.device)
    kw = dict(operand_bytes=2 if tc.mixed_precision else 4)
    ref = follow(run.config["config"], w0, pool, seeds, bow, **kw)
    low = follow(run.config["config"], w0, pool, seeds, bow, precision=Precision(fp8=True), **kw)
    med = float(np.median(list(ref["grad_norms"].values())))
    keep = {n for n, v in ref["grad_norms"].items() if v >= 1e-3 * med}.__contains__
    grad = leaf_gap(low["grad_norms"], ref["grad_norms"], keep)
    change = leaf_gap(low["change_norms"], ref["change_norms"], keep)
    return {
        "loss_gap": max(abs(p[k] - r[k]) / abs(r[k])
                        for p, r in zip(low["losses"], ref["losses"]) for k in r),
        "grad_gap": grad[0], "change_gap": change[0],
        "grad_median_gap": grad[3], "change_median_gap": change[3],
        "losses": [[x[k] for k in COMPONENTS] for x in low["losses"]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        run = cell_run(args.workload, seed, device)
        if args.what == "control":
            kind = run.traffic["kind"]
            out = train_control(run) if kind == "train_steps" else serve_control(run)
        else:
            fault = FAULTS[args.what.split(":", 1)[1]]() if args.what.startswith("fault:") \
                else None
            with fault if fault is not None else contextlib.nullcontext():
                line, _ = bench.run_cell(args.workload, seed, 0, False, device)
            out = {k: v["value"] for k, v in line["checks"].items()}
            out["correct"] = line["correct"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "seconds": round(time.time() - t0, 1), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
