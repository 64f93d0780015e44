"""The port's experiment CLIs against the JAX package's tools.

* ``cli.ablation_sweep.VARIANTS`` equal ``tools/ablation_sweep.VARIANTS``;
* ``summarize_run``, ``compute_verdict`` and ``cli.train_proof.summarize``
  return the JAX tools' dicts on the same hand-written ``metrics.jsonl``
  files: a run that learns, one whose ordering is inverted, and one with an
  empty validation log;
* tiny CPU runs (hidden 48, ``--device cpu``): ``cli.train_proof`` for 1 + 1
  epochs writes its summary and resumes at epoch 1, and ``cli.ablation_sweep
  --only full no_fusion_transformer --epochs 1`` writes both rows and a
  verdict line, then keeps them on ``--resume`` without training again;
* ``cli.accum_curve_check`` at 2 windows sets the two arms' numerics as the
  JAX tool sets its fast arm, with the float32 carry and first moment as
  the reference arm, passes at the default tolerance and fails at 0.

The CLIs' small runs shrink the region encoders' tokens below 128 (conv
strides 2, 2 in the sweep, T = 96 in the proof), so attention takes its
softmax route, the cheap one on the CPU."""

import json
import sys

import pytest

from imagined_speech_translation_tpu_torch.cli import (
    ablation_sweep,
    accum_curve_check,
    train_proof,
)
from imagined_speech_translation_tpu_torch.cli.profile import TINY_OVERRIDES
from tests.test_torch_models import few_threads  # noqa: F401
from tools import ablation_sweep as jax_sweep
from tools import accum_curve_check as jax_curve
from tools import train_proof as jax_proof

NAMES = [name for name, *_ in ablation_sweep.VARIANTS]


def test_variants_equal_the_jax_tools():
    assert ablation_sweep.VARIANTS == jax_sweep.VARIANTS


def _write_run(path, losses, vals, weights=()):
    """A ``metrics.jsonl`` as the trainer writes it: step losses, val
    records (``(epoch, bleu_1, bleu_4, exact_match)``), adaptive weights and
    one prediction table a val record."""
    path.mkdir(parents=True, exist_ok=True)
    records = [{"train/loss": v, "train/loss_ce": v * 0.9} for v in losses]
    for epoch, b1, b4, em in vals:
        records.append({"val/bleu_1": b1, "val/bleu_4": b4, "val/exact_match": em,
                        "val/diversity_score": 0.125 + epoch / 100,
                        "val/total_predictions": 64, "epoch": epoch})
        records.append({"_table": "val/examples", "columns": ["epoch"], "rows": [[epoch]]})
    for w in weights:
        records.append({f"weights/{k}": v for k, v in w.items()})
    path.joinpath("metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    return path


# (losses, val records) a variant: the full model first, the CNN family last
LEARNING = {
    name: ([4.0 - 0.1 * i * (7 - rank) / 7 for i in range(24)],
           [(e, 10.0 + e * (7 - rank), 2.0 * e * (7 - rank) / 7, 5.0 * e * (7 - rank) / 7)
            for e in range(3)])
    for rank, name in enumerate(["full", "no_pos_emb", "uniform_region_weight",
                                 "no_cross_region_attn", "no_fusion_transformer",
                                 "cnn_only_region", "pure_cnn"])
}
CASES = {
    "learning": LEARNING,
    # pure CNN beats the full model
    "inverted": dict(LEARNING, full=LEARNING["pure_cnn"], pure_cnn=LEARNING["full"]),
    # no evaluation logged (a run cut before its first one), few step losses
    "empty_val": {name: ([3.0, 2.5, 2.9], []) for name in NAMES},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_summaries_and_verdict_match_the_jax_tools(tmp_path, case):
    ours, theirs = {}, {}
    for name, (losses, vals) in CASES[case].items():
        run = _write_run(tmp_path / name, losses, vals,
                         [{"ce": 1.0, "align": 0.5}, {"ce": 0.9, "align": 0.7}])
        ours[name] = ablation_sweep.summarize_run(run)
        theirs[name] = jax_sweep.summarize_run(run)
        assert ours[name] == theirs[name]
        assert train_proof.summarize(run) == jax_proof.summarize(run)
    verdict = ablation_sweep.compute_verdict(ours)
    assert verdict == jax_sweep.compute_verdict(theirs)
    failures = ablation_sweep.ordering_failures(ours, verdict)
    if case == "learning":
        assert all(v["reproduced"] for v in verdict.values()) and failures == []
    else:
        assert failures
    if case == "inverted":
        assert not any(v["reproduced"] for v in verdict.values())
        assert all("INVERTED" in f for f in failures)
    rows = {n: dict(r, label=label, paper_bleu1=bleu1)
            for (n, label, bleu1, _), r in zip(ablation_sweep.VARIANTS, ours.values())}
    lines = ablation_sweep.table_lines(rows, verdict, 3, 48, 384)
    assert [ln for ln in lines if ln.startswith("* ordering")] == [
        f"* {v['line']}" for v in verdict.values()]


def test_train_proof_writes_its_summary_and_resumes(tmp_path):
    out = tmp_path / "proof"
    rc = train_proof.main([
        "--device", "cpu", "--out", str(out), "--hidden", "48", "--timepoints", "96",
        "--samples-per-file", "4", "--epochs1", "1", "--epochs2", "2",
    ])
    summary = json.loads((out / "PROOF_SUMMARY.json").read_text())
    checks = summary["criteria"]
    assert set(checks) == {"loss_falls", "bleu4_above_0", "bleu1_rises", "weights_move",
                           "tables_logged", "resume_restores"}
    assert checks["resume_restores"] and checks["tables_logged"]
    assert rc == (0 if all(checks.values()) else 1) and summary["ok"] == (rc == 0)
    assert {"checkpoint_epoch_1", "checkpoint_epoch_2"} <= set(summary["checkpoints"])
    assert len(summary["val_bleu4"]) == 2 and summary["n_step_records"] >= 2
    assert {k: v for k, v in summary.items() if k not in ("criteria", "ok")} == (
        jax_proof.summarize(out))


def test_ablation_sweep_writes_both_rows_and_resumes(tmp_path, monkeypatch):
    out = tmp_path / "sweep"
    argv = ["--device", "cpu", "--out", str(out), "--hidden", "48", "--samples-per-file", "4",
            "--epochs", "1", "--only", "full", "no_fusion_transformer",
            "--set", "model.brain_encoder.region_encoder.conv_strides=[2,2,1,1,1]"]
    assert ablation_sweep.main(argv) == 0
    payload = json.loads((out / "results.json").read_text())
    assert list(payload["results"]) == ["full", "no_fusion_transformer"]
    row = payload["results"]["no_fusion_transformer"]
    assert row["overrides"] == ["model.brain_encoder.fusion_layers=0"] and row["n_evals"] == 1
    assert row == {**row, **jax_sweep.summarize_run(out / "no_fusion_transformer")}
    table = (out / "TABLE.md").read_text()
    assert "| Ours (full) |" in table and "| no fusion transformer |" in table
    assert [ln for ln in table.splitlines() if ln.startswith("* ordering")] == [
        f"* {v['line']}" for v in payload["verdict"].values()] != []
    assert not (out / "full" / "checkpoints").exists()

    def no_training(argv):
        raise AssertionError("--resume trained a variant it had")

    monkeypatch.setattr(ablation_sweep, "run_stage", no_training)
    assert ablation_sweep.main(argv + ["--resume"]) == 0
    assert json.loads((out / "results.json").read_text()) == payload


@pytest.fixture(scope="module")
def jax_arms(tmp_path_factory):
    """The configurations the JAX tool gives its two arms (its ``run_arm``
    replaced by a recorder)."""
    arms = []

    def record(cfg, args, label):
        arms.append(cfg)
        return [2.0, 1.0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_curve, "run_arm", record)
        mp.setattr("imagined_speech_translation_tpu.utils.cache.enable_persistent_cache",
                   lambda *a, **k: None)
        mp.setattr(sys, "argv", ["accum_curve_check", "--windows", "2", "--accum", "2",
                                 "--json", str(tmp_path_factory.mktemp("jax") / "c.json")])
        assert jax_curve.main() == 0
    return arms


def test_accum_curve_arms_match_the_jax_tool(jax_arms):
    ref, fast = accum_curve_check.arm_configs(2, set(accum_curve_check.FAST_FLAGS))
    jax_base, jax_fast = jax_arms
    assert fast.to_dict() == jax_fast.to_dict()
    assert (fast.training.grad_accum_dtype, fast.training.optimizer.mu_dtype) == (
        "bfloat16", "bfloat16")
    assert (ref.training.grad_accum_dtype, ref.training.optimizer.mu_dtype) == ("float32", None)
    # the reference arm is the JAX tool's base with the float32 numerics
    want = jax_base.to_dict()
    want["training"]["grad_accum_dtype"] = "float32"
    want["training"]["optimizer"]["mu_dtype"] = None
    assert ref.to_dict() == want


@pytest.mark.parametrize("tol,rc", [("0.02", 0), ("0", 1)])
def test_accum_curve_check_runs_and_fails_at_zero_tolerance(tmp_path, tol, rc):
    report_path = tmp_path / "curve.json"
    sets = [f"--set={p}={json.dumps(v)}" for p, v in TINY_OVERRIDES]
    argv = ["--device", "cpu", "--windows", "2", "--distinct", "1", "--micro", "2",
            "--accum", "2", "--tol", tol, "--json", str(report_path), *sets,
            "--set", "training.optimizer.warmup_steps=0"]
    assert accum_curve_check.main(argv) == rc
    report = json.loads(report_path.read_text())
    assert report["reference_numerics"] == {"grad_accum_dtype": "float32",
                                            "mu_dtype": "float32"}
    assert report["fast_numerics"] == {"grad_accum_dtype": "bfloat16", "mu_dtype": "bfloat16"}
    assert len(report["ref_losses"]) == len(report["fast_losses"]) == 2
    assert report["ok"] == (rc == 0)
    assert report["ref_first_last"][1] < report["ref_first_last"][0]
