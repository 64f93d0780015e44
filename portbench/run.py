"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout.  Everything that belongs to one configuration, one traffic mix
or one per-layer metric is a file of its own, found by name:

* ``portbench/configs/<config>.json``: the configuration tree as it is run
  (``config``), with its source, what was reduced and what was assumed;
* ``portbench/traffic/<traffic>.json``: the mix's parameters; its ``kind``
  names the driver ``portbench/traffic/<kind>.py``, whose ``run(run)``
  builds the system, measures and judges it;
* ``portbench/limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
* ``portbench/metrics/<metric>.py`` (else the file of the name's part
  before its first dot): ``read(layer) -> float | None``.

``--trace 0`` measures the cell's end-to-end metrics over ``--seconds``;
``--trace 1`` runs a few steady batches or steps under the profiler and
reports the per-layer metrics, the device's busy and traced seconds and the
breakdown.  Both check the outputs against the plain reference once the
window has closed and print each compared number beside its limit, on
standard error and as the last key of the result: the last line of
standard output, one JSON object.  A run without enough CUDA cards, or one
that finds the JAX package or JAX loaded once the window has closed, exits
with another code than 0 and prints no result.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")

from portbench.core import Run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imagined_speech_translation_tpu")


def load_py(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(bench: dict, key: str, name: str) -> dict:
    for entry in bench[key]:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"BENCHMARK.json has no {key} entry named {name!r}")


def layer_metrics(bench: dict, cell: dict, reported: set) -> list[dict]:
    """The per-layer metrics of ``cell``: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def cell_end_to_end(bench: dict, cell: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT) -> tuple[dict, Outcome]:
    """Run the cell on ``device`` (no check that it is a card); returns the
    result line's object and the driver's outcome."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find(bench, "workloads", workload)
    conf = find(bench, "configs", cell["config"])
    pb = root / "portbench"
    traffic = json.loads((pb / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_path = pb / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    run = Run(cell=cell, config=json.loads((root / conf["file"]).read_text()), traffic=traffic,
              limits=limits.get("limits", {}), seed=seed, seconds=seconds, trace=trace,
              device=device, start=START)
    driver = load_py(pb / "traffic" / f"{traffic['kind']}.py", f"portbench_kind_{traffic['kind']}")
    out = driver.run(run)
    e2e = cell_end_to_end(bench, cell)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if trace:
        for m in layer_metrics(bench, cell, {x["name"] for x in e2e}):
            path = pb / "metrics" / f"{m['name']}.py"
            if not path.exists():
                path = pb / "metrics" / f"{m['name'].split('.')[0]}.py"
            value = load_py(path, "portbench_metric_" + path.stem.replace(".", "_")).read(
                dict(out.layer, metric=m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        for m in e2e:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": float(out.metrics[m["name"]]), "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    device_info = {"platform": "gpu" if getattr(device, "type", "") == "cuda" else "cpu",
                   "kind": _device_kind(device), "count": cell["chips"],
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        device_info["busy_s"] = out.busy_s
        device_info["window_s"] = out.window_s
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device_info}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {name: {"value": float(v), "limit": float(lim)}
                      for name, v, lim in out.checks}
    line["checks"]["failed"] = {"value": int(out.failed), "limit": 0}
    return line, out


def _device_kind(device) -> str:
    import torch

    if getattr(device, "type", "") == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = find(bench, "workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.set_num_threads(2)  # one host thread paces the cells; few threads beside it
    line, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = loaded_forbidden()
    if bad:
        print(f"the process loaded {', '.join(bad)}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
