"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, as new files beside the others; and ``BENCHMARK.json`` keeps to
its allowed names, units and keys."""

import json
import re
import tempfile
from pathlib import Path

import torch

from portbench import run as bench
from portbench.tests.tiny import REPO, make_root, tiny_tree

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_new_files_are_found_by_name():
    """A configuration, a traffic mix and a per-layer metric added as new
    files in a copy, and a cell that uses them: no file is edited but
    ``BENCHMARK.json``, which lists the new entries."""
    root = make_root(tempfile.mkdtemp())
    conf = {"name": "tiny844", "source": "tests", "reduced": [], "config": tiny_tree((4, 2, 2))}
    (root / "portbench/configs/tiny844.json").write_text(json.dumps(conf))
    (root / "portbench/traffic/serve_two.json").write_text(json.dumps({
        "kind": "offline_serve", "batch": 2, "pool_batches": 2, "n_channels": 64,
        "decode_length": 6, "compute_dtype": "bfloat16", "trace_batches": 2,
        "check_windows": 3}))
    (root / "portbench/metrics/served_windows.py").write_text(
        "def read(layer):\n    return layer.get('windows')\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny844", "source": "tests",
                         "file": "portbench/configs/tiny844.json", "reduced": [], "why": "t"})
    b["workloads"].append({"name": "two", "config": "tiny844", "traffic": "serve_two",
                           "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "served_windows", "unit": "windows", "better": "higher",
                           "source": "program_counter", "layer": "tests",
                           "moves": "windows_per_s", "workloads": ["two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    line, out = bench.run_cell("two", 3, 0, True, torch.device("cpu"), root=root)
    assert line["metrics"]["served_windows"] == {"value": 4.0, "unit": "windows"}
    assert list(line)[-1] == "checks" and set(line["checks"]) == {"beam_gap", "failed"}
    # two batches of two untraced, then the same two traced: all are judged
    assert line["attempted"] == 8 and line["failed"] == 0
    line, _ = bench.run_cell("two", 3, 0, False, torch.device("cpu"), root=root)
    assert set(line["metrics"]) == {"windows_per_s", "setup_s"}


def test_benchmark_json_keeps_to_its_contract():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(ONE_LINE.match(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "portbench/limits" / f"{w['name']}.json").exists()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        reader = REPO / "portbench/metrics" / f"{m['name']}.py"
        assert reader.exists() or (REPO / "portbench/metrics" /
                                   f"{m['name'].split('.')[0]}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for cell in cells:  # every cell reports setup_s, another end-to-end and a per-layer metric
        reported = {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    for path in (REPO / "portbench").rglob("*"):
        rel = str(path.relative_to(REPO))
        assert "__pycache__" in rel or PATH.match(rel), rel
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        return
    assert bench.main(["--workload", "serve-b64-heads666", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
