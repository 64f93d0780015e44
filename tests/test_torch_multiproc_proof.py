"""The port's multi-process proof (``cli/multiproc_proof.py``) on the CPU.

One run (``--device cpu``, module-scoped): a single-process reference, then
four gloo ranks through the ``IST_*`` variables over ``make_mesh(n_dcn=2)``,
``{dcn: 2, data: 2, model: 1}``.  The tests read its ``result.json``, as
``tests/test_multiproc.py`` reads the JAX proof's: ``ok``, four processes,
the mesh, the checkpoint written once and restored bit for bit on every
rank, each rank on the rows of its shard ``dcn_idx * n_data + data_idx``,
and the loss within 1e-5 of the single process's.
"""

import json
from pathlib import Path

import pytest

from imagined_speech_translation_tpu_torch.cli import multiproc_proof

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = tmp_path_factory.mktemp("multiproc_proof")
    assert multiproc_proof.main(["--device", "cpu", "--out", str(out)]) == 0
    return json.loads((out / "result.json").read_text())


def test_four_process_proof(result):
    assert result["ok"]
    assert result["process_count"] == 4
    assert result["mesh_shape"] == {"dcn": 2, "data": 2, "model": 1}
    assert result["backend"] == "gloo"
    assert result["loss_delta"] <= 1e-5


def test_checkpoint_written_once_and_restored_on_every_rank(result):
    assert result["checkpoint_roundtrip_ok"] and result["checkpoint_written_once"]
    assert result["checkpoint_files"] == ["best_model", "best_model/meta.json",
                                          "best_model/state.pt"]
    assert [r["step"] for r in result["ranks"]] == [1] * 4


def test_ranks_hold_their_shards_rows(result):
    assert result["rows_by_shard_ok"]
    coords = {r["rank"]: (r["coords"]["dcn"], r["coords"]["data"]) for r in result["ranks"]}
    assert coords == {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1)}
    assert [r["shard_index"] for r in result["ranks"]] == [0, 1, 2, 3]
    # the ranks' all-reduced loss is one number
    assert len(set(result["loss_multiprocess_by_rank"])) == 1


def test_default_out_is_under_build(monkeypatch):
    seen = {}

    def orchestrate(out, *, device):
        seen.update(out=out, device=device)
        return {"ok": True}

    monkeypatch.setattr(multiproc_proof, "orchestrate", orchestrate)
    assert multiproc_proof.main(["--device", "cpu"]) == 0
    assert seen == {"out": REPO / "build" / "multiproc_proof", "device": "cpu"}
