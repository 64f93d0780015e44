"""Ablation sweep: paper Table 24's variants through the port's ``cli.train``.

Port of ``tools/ablation_sweep.py``.  The reference paper (Table 24)
ablates the architecture: no cross-region attention, uniform region
weights, no positional embedding, CNN-only region encoder, no fusion
transformer, and pure CNN.  Each is a configuration
(``RegionEncoderConfig.cnn_only`` / ``use_positional_embedding``,
``BrainEncoderConfig.disable_cross_region_attn`` / ``uniform_region_weight``
/ ``fusion_layers``); this tool trains each variant on the ECHO synthetic
corpus (``data/synthetic.py``: pair-local spectral signatures + per-slot
anchor/echo burst pairs whose ordered code is invisible to
permutation-invariant pooling of local features) and checks the paper's
orderings directionally: the full model beats every ablation, and the
CNN-family variants (CNN-only region encoder, pure CNN) land at the bottom.
The verdict is computed from the rows (``compute_verdict``), never written
by hand.  Exact paper numbers need the real Chisco data::

    WANDB_MODE=disabled python -m imagined_speech_translation_tpu_torch.cli.ablation_sweep \\
        [--out runs/torch_ablations] [--epochs 8] [--only full pure_cnn] [--device cuda]

Writes ``<out>/results.json`` and ``<out>/TABLE.md``; exits 1 when a full
sweep (no ``--only``, no ``--no-assert``) misses an ordering.  ``--set``
passes more ``cli.train`` overrides (a pilot's), applied before each
variant's own.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

from .train_proof import build_corpus, run_stage, width_overrides


def _n_corpus_texts() -> int:
    from ..data.synthetic import DEFAULT_TEXTS

    return len(DEFAULT_TEXTS)


# (name, paper label, paper BLEU-1, overrides)
VARIANTS = [
    ("full", "Ours (full)", 49.6, []),
    (
        "no_cross_region_attn", "no cross-region attn", 43.8,
        ["model.brain_encoder.disable_cross_region_attn=true"],
    ),
    (
        "uniform_region_weight", "uniform region weights", 46.1,
        ["model.brain_encoder.uniform_region_weight=true"],
    ),
    (
        "no_pos_emb", "no positional embedding", 47.5,
        ["model.brain_encoder.region_encoder.use_positional_embedding=false"],
    ),
    (
        "cnn_only_region", "CNN-only region encoder", 38.2,
        ["model.brain_encoder.region_encoder.cnn_only=true"],
    ),
    (
        "no_fusion_transformer", "no fusion transformer", 42.2,
        ["model.brain_encoder.fusion_layers=0"],
    ),
    (
        "pure_cnn", "pure CNN", 33.9,
        [
            "model.brain_encoder.region_encoder.cnn_only=true",
            "model.brain_encoder.disable_cross_region_attn=true",
            "model.brain_encoder.uniform_region_weight=true",
        ],
    ),
]


def variant_config(cfg, name: str):
    """``cfg`` with the overrides of variant ``name`` applied and validated."""
    from .train import parse_override

    (extra,) = [ov for n, *_, ov in VARIANTS if n == name]
    for expr in extra:
        cfg = parse_override(cfg, expr)
    return cfg.validate()


def summarize_run(out_dir: Path) -> dict:
    records = [
        json.loads(line)
        for line in (out_dir / "metrics.jsonl").read_text().splitlines()
        if line.strip()
    ]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    val = [r for r in records if "val/bleu_1" in r]
    # non-overlapping head/tail windows: at most a quarter of the series
    # each, so sparse logs (log_every_steps > steps/epoch) can't alias the
    # two means into equality
    w = max(1, min(10, len(losses) // 4))
    return {
        "first_loss": round(sum(losses[:w]) / max(len(losses[:w]), 1), 4),
        "last_loss": round(sum(losses[-w:]) / max(len(losses[-w:]), 1), 4),
        "best_bleu1": round(max(r["val/bleu_1"] for r in val), 3) if val else 0.0,
        "best_bleu4": round(
            max(r.get("val/bleu_4", 0.0) for r in val), 3
        ) if val else 0.0,
        # sequence accuracy: % of val samples whose decoded text matches the
        # reference exactly, the collapse-robust "did it read the code"
        # measurement
        "best_em": round(
            max(r.get("val/exact_match", 0.0) for r in val), 3
        ) if val else 0.0,
        "final_em": round(val[-1].get("val/exact_match", 0.0), 3) if val else 0.0,
        "final_diversity": round(
            val[-1].get("val/diversity_score", 0.0), 3
        ) if val else 0.0,
        # unique-prediction diversity saturates at n_classes/n_eval on a
        # class-conditioned corpus (8 texts over 64 eval samples: 0.125 for
        # a perfect decoder), so report the cap next to the score
        "diversity_cap": round(
            _n_corpus_texts() / val[-1]["val/total_predictions"], 3
        ) if val and val[-1].get("val/total_predictions") else None,
        "n_evals": len(val),
    }


def compute_verdict(results: dict) -> dict:
    """The ordering verdict, derived from the results.

    Checks, per metric (BLEU-1 and exact-match):
    * ``full_beats_all``: full >= every ablation;
    * ``cnn_family_bottom``: the two lowest scores are the CNN-family
      variants (paper Table 24's bottom rows).
    """
    verdicts = {}
    for metric in ("best_bleu1", "best_em"):
        if "full" not in results:
            continue
        full = results["full"][metric]
        others = {n: r[metric] for n, r in results.items() if n != "full"}
        if not others:
            continue
        max_abl_name = max(others, key=others.get)
        ranked = sorted(results, key=lambda n: results[n][metric])
        full_beats_all = all(full >= v for v in others.values())
        cnn_bottom = set(ranked[:2]) == {"cnn_only_region", "pure_cnn"}
        reproduced = full_beats_all and cnn_bottom
        verdicts[metric] = {
            "reproduced": reproduced,
            "full": full,
            "max_ablation": {max_abl_name: others[max_abl_name]},
            "ranking_low_to_high": ranked,
            "line": (
                f"ordering ({metric}): "
                + ("REPRODUCED" if reproduced else "INVERTED")
                + f" — full {full} vs max-ablation "
                f"{others[max_abl_name]} ({max_abl_name}); "
                f"CNN-family at bottom: {cnn_bottom} "
                f"(lowest two: {ranked[:2]})"
            ),
        }
    return verdicts


def table_lines(results: dict, verdicts: dict, epochs: int, hidden: int,
                timepoints: int) -> list[str]:
    """``TABLE.md``'s lines: the corpus, the generated verdict, the rows."""
    lines = [
        "# Ablation sweep (echo synthetic corpus, the port's cli.train, "
        f"{epochs} epochs, hidden {hidden}, T={timepoints})",
        "",
        "Paper Table 24 gives the real-data orderings (full model beats every",
        "ablation; CNN-only and pure-CNN rows at the bottom).  This sweep",
        "tests whether the same orderings emerge on the echo synthetic",
        "corpus: class pairs share a region-local spectral signature (the",
        "easy half, readable by any conv stem); the pair MEMBER is coded by",
        "per-slot anchor/echo burst ordering at a 64-sample lag (beyond the",
        "conv receptive field 25), with positional-only slots (0/2) and one",
        "XOR-masked content-ordered slot (1), so reading the member needs",
        "in-region token attention + cross-region integration.  30% of",
        "samples corrupt one region (3x noise), rewarding dynamic gating.",
        "From-scratch LRs (bart/projection 3e-4): the reference's 3e-5 BART",
        "LR assumes a pretrained decoder.",
        "",
        "Exact-match = sequence accuracy (decoded text == reference), the",
        "collapse-robust measurement.  Diversity (unique/total) saturates at",
        "n_texts/n_eval on this corpus (cap in the last column), so the",
        "reference's 0.3 collapse gate cannot be reached at this eval size.",
        "",
        "## Verdict (generated from the rows below)",
        "",
    ]
    for v in verdicts.values():
        lines.append(f"* {v['line']}")
    lines += [
        "",
        "| variant | paper BLEU-1 | synth best BLEU-1 | synth best BLEU-4 |"
        " best exact-match % | loss first→last | diversity (cap) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in results.values():
        lines.append(
            f"| {r['label']} | {r['paper_bleu1']} | {r['best_bleu1']} |"
            f" {r['best_bleu4']} | {r['best_em']} |"
            f" {r['first_loss']}→{r['last_loss']} |"
            f" {r['final_diversity']} ({r['diversity_cap']}) |"
        )
    return lines


def ordering_failures(results: dict, verdicts: dict) -> list[str]:
    """What a full sweep misses of the directional reproduction: a variant
    that did not train, an ordering the verdict calls inverted, or BLEU-1
    outcomes within 5 points of each other."""
    out = []
    if not all(r["last_loss"] < r["first_loss"] for r in results.values()):
        out.append("some variant failed to train")
    out += [verdicts[m]["line"] for m in ("best_bleu1", "best_em")
            if not verdicts.get(m, {}).get("reproduced")]
    bleus = [r["best_bleu1"] for r in results.values()]
    if not max(bleus) - min(bleus) > 5.0:
        out.append("ablation variants produced undifferentiated outcomes")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/torch_ablations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timepoints", type=int, default=384)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--only", nargs="*", default=None, help="variant names")
    ap.add_argument(
        "--hidden", type=int, default=384,
        help="model width (CPU pilots shrink this; conv stack scales with it)",
    )
    ap.add_argument("--samples-per-file", type=int, default=64)
    ap.add_argument(
        "--eval-every", type=int, default=1,
        help="beam-decode eval every N epochs",
    )
    ap.add_argument(
        "--no-assert", action="store_true",
        help="table only: skip the ordering checks (pilot runs)",
    )
    ap.add_argument("--set", action="append", dest="overrides", default=[],
                    metavar="PATH=VAL",
                    help="more cli.train overrides (pilot runs), applied before each "
                    "variant's own")
    ap.add_argument(
        "--resume", action="store_true",
        help="keep finished variants from an existing results.json and only "
        "train the missing ones (the corpus is seeded, so resumed variants "
        "see identical data)",
    )
    args = ap.parse_args(argv)
    # the sweep reads metrics.jsonl; wandb would only try to reach its server
    os.environ.setdefault("WANDB_MODE", "disabled")

    out_root = Path(args.out)
    out_root.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ist_ablate_"))
    results = {}
    try:
        # echo corpus: reading the pair member needs in-region token
        # attention (ablated by cnn_only) + cross-region integration; 30% of
        # samples corrupt one region, rewarding dynamic gating
        data_dir, montage, vocab = build_corpus(
            root, args.timepoints, mode="echo",
            samples_per_file=args.samples_per_file,
        )
        prior_path = out_root / "results.json"
        if args.resume and prior_path.exists():
            prior = json.loads(prior_path.read_text())
            results.update(prior.get("results", prior))
        for name, label, paper_bleu1, extra in VARIANTS:
            if args.only and name not in args.only:
                continue
            if args.resume and name in results:
                print(f"=== ablation: {name} (kept from results.json) ===", flush=True)
                continue
            run_dir = out_root / name
            if run_dir.exists():
                shutil.rmtree(run_dir)
            print(f"=== ablation: {name} ({label}) ===", flush=True)
            cli = [
                "--data-dir", str(data_dir), "--montage", str(montage),
                "--vocab", str(vocab), "--out-dir", str(run_dir),
                "--device", args.device,
                "--set", f"data.n_timepoints={args.timepoints}",
                *width_overrides(args.hidden),
                "--set", "training.mixed_precision=true",
                # the reference's 3e-5 BART group LR assumes a PRETRAINED
                # decoder being fine-tuned; this sweep trains from scratch,
                # so the decoder/projection groups get the encoder's LR
                "--set", "training.optimizer.bart_lr=3e-4",
                "--set", "training.optimizer.projection_lr=3e-4",
                "--set", "training.optimizer.warmup_steps=60",
                "--set", "training.checkpoint.save_interval_epochs=1000",
                "--set", "training.log_every_steps=8",
                # patience must not bind inside the sweep: check_improvement
                # gates on diversity >= 0.3, unreachable on a class-conditioned
                # corpus, so the counter ticks every eval; each variant gets
                # the same fixed epoch budget instead
                "--set", f"training.patience={args.epochs + 1}",
                "--set", f"training.eval_interval_epochs={args.eval_every}",
                "--set", f"training.num_epochs={args.epochs}",
            ]
            for ov in [*args.overrides, *extra]:
                cli += ["--set", ov]
            run_stage(cli)
            results[name] = {
                "label": label,
                "paper_bleu1": paper_bleu1,
                "overrides": extra,
                **summarize_run(run_dir),
            }
            # keep the sweep light on disk: metrics only, no checkpoints
            shutil.rmtree(run_dir / "checkpoints", ignore_errors=True)
            (out_root / "results.json").write_text(json.dumps(results, indent=2))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    results = {n: results[n] for n, *_ in VARIANTS if n in results}
    verdicts = compute_verdict(results)
    payload = {"results": results, "verdict": verdicts, "regime": {
        "epochs": args.epochs, "hidden": args.hidden,
        "timepoints": args.timepoints,
        "samples_per_file": args.samples_per_file,
    }}
    (out_root / "results.json").write_text(json.dumps(payload, indent=2))
    (out_root / "TABLE.md").write_text(
        "\n".join(table_lines(results, verdicts, args.epochs, args.hidden,
                              args.timepoints)) + "\n")
    print(json.dumps(payload, indent=2))

    if not args.only and not args.no_assert:
        # directional reproduction of Table 24 on the echo corpus, by the
        # same computation that wrote the table's verdict lines
        failures = ordering_failures(results, verdicts)
        if failures:
            print("ABLATION SWEEP FAILED: " + "; ".join(failures))
            return 1
    print("ABLATION SWEEP OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
