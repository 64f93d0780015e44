"""``correct`` comes out false where it should: the control (the reference
in float8 in the program's place) and each fault a cell can have, planted
under the harness, at tiny widths on the CPU; and on a card at the cells'
own sizes (marked ``card``).

The tiny cells' limits are set here from their own readings (sound runs:
``beam_gap`` 0 to 0.003 nats; training gaps of loss, worst and median leaf
at most 0.0098 / 0.058 / 0.047 / 0.0089 / 0.0038 over four seeds, the
control's least 0.048 / 0.25 / 0.105 / 0.028 / 0.010),
as the cells' limits in ``portbench/limits`` are set from the card's."""

import json
import tempfile

import pytest
import torch

from portbench import control
from portbench import run as bench
from portbench.core import Run
from portbench.faults import FAULTS
from portbench.tests.tiny import TRAFFIC, make_root, tiny_tree

CPU = torch.device("cpu")
LIMITS = {"serve-tiny": {"beam_gap": 0.02},
          "train-tiny": {"loss_gap": 0.02, "grad_gap": 0.15, "change_gap": 0.15,
                         "grad_median_gap": 0.015, "change_median_gap": 0.007}}


@pytest.fixture(scope="module")
def root():
    return make_root(tempfile.mkdtemp(), LIMITS)


@pytest.mark.parametrize("cell", ["serve-tiny", "train-tiny"])
def test_sound_runs_are_correct(root, cell):
    line, _ = bench.run_cell(cell, 21, 0, False, CPU, root=root)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", [("serve-tiny", "token"), ("serve-tiny", "roll"),
                                        ("serve-tiny", "encoder"), ("train-tiny", "half"),
                                        ("train-tiny", "unchanged")])
def test_a_fault_is_not_correct(root, cell, fault):
    with FAULTS[fault]():
        line, _ = bench.run_cell(cell, 22, 0, False, CPU, root=root)
    assert not line["correct"], line["checks"]


def tiny_run(traffic: str, seed: int) -> Run:
    return Run(cell={}, config={"config": tiny_tree()}, traffic=TRAFFIC[traffic], limits={},
               seed=seed, seconds=0, trace=False, device=CPU)


def test_the_serving_control_is_not_correct():
    out = control.serve_control(tiny_run("serve_tiny", 23))
    assert out["control_beam_gap"] > LIMITS["serve-tiny"]["beam_gap"]
    assert out["program_beam_gap"] <= LIMITS["serve-tiny"]["beam_gap"]


def test_the_training_control_is_not_correct():
    out = control.train_control(tiny_run("train_tiny", 24))
    assert any(out[k] > v for k, v in LIMITS["train-tiny"].items()), out


CELLS = [w["name"] for w in json.loads((bench.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    """The control on the card at the cell's own size, against the cell's
    committed limits."""
    run = control.cell_run(cell, 31, card)
    limits = json.loads((bench.ROOT / f"portbench/limits/{cell}.json").read_text())
    lim = limits["limits"]
    if run.traffic["kind"] == "train_steps":
        out = control.train_control(run)
        assert any(out[k] > v for k, v in lim.items()), out
    else:
        out = control.serve_control(run)
        assert out["control_beam_gap"] > lim["beam_gap"] >= out["program_beam_gap"]
