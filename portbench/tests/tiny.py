"""A tiny copy of the benchmark for the CPU tests: the cells' drivers over
a configuration a few thousand times smaller, in a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_tree(heads=(2, 2, 2), length: int = 256) -> dict:
    tree = json.loads((REPO / "portbench/configs/ist-heads666.json").read_text())["config"]
    tree["data"].update(n_timepoints=length)
    m = tree["model"]
    m.update(hidden_dim=32)
    m["brain_encoder"].update(hidden_dim=32, fusion_heads=4, cross_region_heads=4)
    m["brain_encoder"]["region_encoder"].update(conv_channels=[8, 16, 24, 32, 32],
                                                attn_heads=list(heads), se_reduction=4)
    m["bart"].update(vocab_size=256, d_model=32, decoder_layers=2, num_heads=4, ffn_dim=64,
                     max_position_embeddings=32)
    tree["training"].update(batch_size=4, grad_accum_steps=2)
    tree["training"]["loss"].update(bow_vocab_size=64)
    tree["training"]["optimizer"].update(warmup_steps=4)
    return tree


TRAFFIC = {
    "serve_tiny": {"kind": "offline_serve", "batch": 4, "pool_batches": 2, "n_channels": 64,
                   "decode_length": 8, "compute_dtype": "bfloat16", "trace_batches": 1,
                   "check_windows": 6},
    "train_tiny": {"kind": "train_steps", "pool_steps": 4, "label_length": 8,
                   "total_steps": 100, "follow_steps": 3, "trace_steps": 1},
}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A root with the benchmark's code, a tiny configuration, its traffic
    files and a ``BENCHMARK.json`` of tiny cells."""
    root = Path(tmp)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = {"name": "tiny", "source": "tests", "reduced": [], "config": tiny_tree()}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    for name, t in TRAFFIC.items():
        (root / f"portbench/traffic/{name}.json").write_text(json.dumps(t))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tests", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": "serve-tiny", "config": "tiny", "traffic": "serve_tiny", "chips": 1, "why": "t"},
        {"name": "train-tiny", "config": "tiny", "traffic": "train_tiny", "chips": 1, "why": "t"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/limits").mkdir(exist_ok=True)
    for cell, lim in (limits or {}).items():
        (root / f"portbench/limits/{cell}.json").write_text(json.dumps({"limits": lim}))
    return root
