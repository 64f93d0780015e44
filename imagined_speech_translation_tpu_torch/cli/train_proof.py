"""Training-system proof: a multi-epoch run through the port's ``cli.train``.

Port of ``tools/train_proof.py``.  It drives the port's training CLI
(``cli.train.main``, in-process) on a few-hundred-sample class-conditioned
synthetic corpus (each sentence has a decodable EEG signature,
``data/synthetic.py``), in two stages:

1. ``--epochs1`` epochs (default 4) from scratch: checkpoints, the adaptive
   loss-weight schedule, collapse detection, prediction tables;
2. ``--resume`` to ``--epochs2`` epochs (default 20): the checkpoint restore
   through the same CLI path.

Then it reads ``metrics.jsonl`` and writes ``PROOF_SUMMARY.json`` (the JAX
tool's ``summarize`` dict, with ``criteria`` and ``ok`` added) and exits 1
unless the training loss falls (first-window mean above the last), val
BLEU-4 rises above 0, val BLEU-1 rises over its first evaluation, the
adaptive weights move, prediction tables were logged and the resumed stage
continued at epoch ``--epochs1`` with every epoch evaluated once::

    WANDB_MODE=disabled python -m imagined_speech_translation_tpu_torch.cli.train_proof \\
        [--out runs/torch_train_proof] [--device cuda]

``--hidden``, ``--samples-per-file`` and ``--set`` (more ``cli.train``
overrides, applied last) shrink a pilot run; their defaults are the JAX
tool's widths (hidden 384, 3 + 3 BART layers, T = 256, 10 files of 32
windows).  The stage-1 checkpoint interval is ``--epochs1`` (the JAX tool's
4 at the default), so stage 2 always has a checkpoint to resume from.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path


def build_corpus(root: Path, n_timepoints: int, *, mode=True, samples_per_file=32):
    """``mode`` is forwarded to ``class_conditioned``: True = per-channel
    signatures (training proof), "echo" = the ablation corpus (see
    ``data/synthetic.py``).  Returns ``(data_dir, montage, vocab)``."""
    from ..data import make_synthetic_corpus, make_synthetic_montage
    from ..data.synthetic import DEFAULT_TEXTS

    data_dir = root / "eeg"
    montage = root / "montage.csv"
    labels = make_synthetic_montage(montage)
    make_synthetic_corpus(
        data_dir, n_files=10, samples_per_file=samples_per_file,
        n_timepoints=n_timepoints, seed=11,
        class_conditioned=mode, noise_scale=0.5,
        montage_labels=labels,
    )
    # vocab.txt covering the corpus texts (BERT-style layout)
    chars = sorted({c for t in DEFAULT_TEXTS for c in t})
    vocab = (
        ["[PAD]"]
        + [f"[unused{i}]" for i in range(10)]
        + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "[EOS]"]
        + chars
    )
    vocab_path = root / "vocab.txt"
    vocab_path.write_text("\n".join(vocab) + "\n")
    return data_dir, montage, vocab_path


def run_stage(args_list) -> dict:
    """The port's ``cli.train.main(args_list)``, in this process."""
    from .train import main

    return main(args_list)


def width_overrides(hidden: int) -> list[str]:
    """``cli.train`` overrides for a model of width ``hidden`` whose conv
    stem scales with it (``[64, 96, 128, 192, 384]`` at 384) and whose BART
    has 3 + 3 layers, as the JAX tools set them."""
    convs = [max(8, hidden * f // 384) for f in (64, 96, 128, 192, 384)]
    out = []
    for expr in (
        f"model.hidden_dim={hidden}",
        f"model.brain_encoder.hidden_dim={hidden}",
        "model.brain_encoder.region_encoder.conv_channels=" + str(convs).replace(" ", ""),
        f"model.bart.d_model={hidden}",
        f"model.bart.ffn_dim={hidden * 4}",
        "model.bart.encoder_layers=3",
        "model.bart.decoder_layers=3",
    ):
        out += ["--set", expr]
    return out


def read_metrics(out_dir: Path) -> list[dict]:
    return [
        json.loads(line)
        for line in (out_dir / "metrics.jsonl").read_text().splitlines()
        if line.strip()
    ]


def summarize(out_dir: Path) -> dict:
    records = read_metrics(out_dir)
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    val = [r for r in records if "val/bleu_4" in r]
    weights = [
        {k: v for k, v in r.items() if k.startswith("weights/")}
        for r in records
        if any(k.startswith("weights/") for k in r)
    ]
    tables = [r for r in records if r.get("_table")]
    summary = {
        "n_step_records": len(losses),
        "first_losses_mean": (
            sum(losses[:10]) / max(len(losses[:10]), 1) if losses else None
        ),
        "last_losses_mean": (
            sum(losses[-10:]) / max(len(losses[-10:]), 1) if losses else None
        ),
        "val_bleu1": [round(r.get("val/bleu_1", 0.0), 3) for r in val],
        "val_bleu4": [round(r["val/bleu_4"], 3) for r in val],
        "val_diversity": [
            round(r.get("val/diversity_score", 0.0), 3) for r in val
        ],
        "adaptive_weights_first": weights[0] if weights else None,
        "adaptive_weights_last": weights[-1] if weights else None,
        "n_prediction_tables": len(tables),
        "checkpoints": sorted(
            p.name for p in (out_dir / "checkpoints").glob("*") if p.is_dir()
        ),
    }
    return summary


def criteria(summary: dict, val_epochs: list, start_epoch: int, epochs1: int,
             epochs2: int) -> dict:
    """The proof's checks, each a bool: ``val_epochs`` are the ``epoch``
    fields of the val records in log order, ``start_epoch`` the epoch the
    resumed stage's trainer started at."""
    first, last = summary["first_losses_mean"], summary["last_losses_mean"]
    bleu1 = summary["val_bleu1"]
    return {
        "loss_falls": summary["n_step_records"] > 0 and last < first,
        "bleu4_above_0": max(summary["val_bleu4"], default=0.0) > 0.0,
        "bleu1_rises": bool(bleu1) and max(bleu1[1:] or bleu1) > bleu1[0],
        "weights_move": (summary["adaptive_weights_first"] is not None
                         and summary["adaptive_weights_first"]
                         != summary["adaptive_weights_last"]),
        "tables_logged": summary["n_prediction_tables"] > 0,
        "resume_restores": start_epoch == epochs1 and val_epochs == list(range(epochs2)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/torch_train_proof")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timepoints", type=int, default=256)
    ap.add_argument("--epochs1", type=int, default=4)
    ap.add_argument("--epochs2", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=384)
    ap.add_argument("--samples-per-file", type=int, default=32)
    ap.add_argument("--set", action="append", dest="overrides", default=[],
                    metavar="PATH=VAL", help="more cli.train overrides, applied last")
    args = ap.parse_args(argv)
    # the proof reads metrics.jsonl; wandb would only try to reach its server
    os.environ.setdefault("WANDB_MODE", "disabled")

    out_dir = Path(args.out)
    if out_dir.exists():
        shutil.rmtree(out_dir)
    root = Path(tempfile.mkdtemp(prefix="ist_proof_"))
    try:
        data_dir, montage, vocab = build_corpus(
            root, args.timepoints, samples_per_file=args.samples_per_file)
        common = [
            "--data-dir", str(data_dir), "--montage", str(montage),
            "--vocab", str(vocab), "--out-dir", str(out_dir), "--device", args.device,
            "--set", f"data.n_timepoints={args.timepoints}",
            *width_overrides(args.hidden),
            "--set", "training.mixed_precision=true",
            "--set", "training.optimizer.warmup_steps=60",
            "--set", f"training.checkpoint.save_interval_epochs={args.epochs1}",
            "--set", "training.log_every_steps=8",
            "--set", "training.patience=30",
        ]
        for expr in args.overrides:
            common += ["--set", expr]

        print(f"=== stage 1: {args.epochs1} epochs from scratch ===", flush=True)
        run_stage(common + ["--set", f"training.num_epochs={args.epochs1}"])
        print(f"=== stage 2: resume -> {args.epochs2} epochs ===", flush=True)
        resumed = run_stage(common + ["--set", f"training.num_epochs={args.epochs2}",
                                      "--resume"])
    finally:
        shutil.rmtree(root, ignore_errors=True)

    summary = summarize(out_dir)
    val_epochs = [r["epoch"] for r in read_metrics(out_dir) if "val/bleu_4" in r]
    checks = criteria(summary, val_epochs, resumed["trainer"].start_epoch, args.epochs1,
                      args.epochs2)
    summary.update(criteria=checks, ok=all(checks.values()))
    (out_dir / "PROOF_SUMMARY.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    if not summary["ok"]:
        print("TRAIN PROOF FAILED: " + ", ".join(k for k, v in checks.items() if not v))
        return 1
    print("TRAIN PROOF OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
