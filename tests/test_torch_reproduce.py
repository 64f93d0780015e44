"""The port's ``cli.reproduce`` against the JAX package's, without a network.

Following ``tests/test_reproduce.py``: a tiny HF checkpoint built from a
``BartConfig`` and saved locally; the offline dry-run plan (the JAX plan,
step for step, with the converted weights as one ``torch.save`` file); the
structured ``blocked: no-egress`` exit with ``probe_egress`` replaced; the
local chain on ``--device cpu`` (convert, then decode parity against HF
``generate`` with identity 1.0 and the JAX ``parity_report``'s per-case
report on the same checkpoint); and ``--train`` handing ``cli.train.main``
the JAX chain's argv plus ``--device``, with both ``train.main`` replaced by
recorders.  ``probe_egress`` is never called for real.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from imagined_speech_translation_tpu.cli import reproduce as jax_reproduce  # noqa: E402
from imagined_speech_translation_tpu_torch.cli import reproduce  # noqa: E402
from tests.test_reproduce import hf_dir  # noqa: E402, F401
from tests.test_torch_models import few_threads  # noqa: E402, F401


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Any probe that was not replaced by the test fails the test."""
    def refuse(url, timeout=8.0):
        raise AssertionError(f"a test probed {url}")

    monkeypatch.setattr(reproduce, "_probe_url", refuse)
    monkeypatch.setattr(jax_reproduce, "_probe_url", refuse)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _local_artifacts(tmp_path):
    data = tmp_path / "chisco"
    data.mkdir()
    (data / "sub-01_task-imagine_run-1_eeg.pkl").write_bytes(b"\x80\x04N.")
    return data


def test_dry_run_plan_is_the_jax_plan(tmp_path, capsys):
    rc = reproduce.main(["--dry-run", "--work-dir", str(tmp_path), "--train"])
    assert rc == 0
    out = _last_json(capsys)
    assert out["status"] == "dry-run-ok"
    args = jax_reproduce.argparse.Namespace(work_dir=str(tmp_path), data_dir=None,
                                            hf_checkpoint=None, train=True)
    want = jax_reproduce.build_plan(args)
    want[2]["out"] += ".pt"  # one torch.save file, not an orbax directory
    assert out["plan"] == want
    assert [s["step"] for s in out["plan"]] == [
        "fetch-chisco", "fetch-hf", "convert-hf", "parity-report", "train"]
    tools = out["tools"]
    assert tools["torch"] and tools["transformers"] and tools["numpy"]
    assert tools["entry_points"] and "jax" not in tools and "orbax.checkpoint" not in tools


def test_blocked_without_egress(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(
        reproduce, "probe_egress",
        lambda urls=None: [{"url": "x", "ok": False, "error": "unreachable"}],
    )
    rc = reproduce.main(["--work-dir", str(tmp_path), "--device", "cpu"])
    assert rc == reproduce.BLOCKED_EXIT == 3
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["status"] == "blocked"
    assert out["reason"] == "no-egress"
    assert out["probes"][0]["error"] == "unreachable"
    assert [s["skipped"] for s in out["plan"]] == [False, False, False, False]
    assert "Traceback" not in captured.out + captured.err
    assert not (tmp_path / "bart_params.pt").exists()


def test_no_card_is_refused_before_any_step(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        reproduce.main(["--work-dir", str(tmp_path)])
    assert not tmp_path.joinpath("parity_report.json").exists()


def test_local_chain_convert_and_parity(tmp_path, hf_dir, capsys):  # noqa: F811
    """With local artifacts the chain needs no network: the port's converter,
    then the port's decoder token-identical to HF ``generate``, case for
    case as the JAX chain reports it."""
    data = _local_artifacts(tmp_path)
    rc = reproduce.main([
        "--work-dir", str(tmp_path / "work"), "--data-dir", str(data),
        "--hf-checkpoint", str(hf_dir), "--parity-cases", "4", "--device", "cpu",
    ])
    out = _last_json(capsys)
    assert rc == 0, out
    assert out == {"status": "ok", "identity": 1.0,
                   "report": str(tmp_path / "work" / "parity_report.json")}
    report = json.loads((tmp_path / "work" / "parity_report.json").read_text())
    assert all(c["identical"] for c in report["cases"])
    assert [c["num_beams"] for c in report["cases"]] == [1, 3, 1, 3]
    want = jax_reproduce.parity_report(hf_dir, None, tmp_path / "jax_report.json", n_cases=4,
                                       log=lambda _: None)
    assert report == want
    # the converted file is the port converter's output on the checkpoint
    from imagined_speech_translation_tpu_torch.cli.convert_hf import infer_decoder_layers
    from imagined_speech_translation_tpu_torch.cli.convert_hf import load_state_dict
    from imagined_speech_translation_tpu_torch.models import convert_hf_bart_state_dict

    saved = torch.load(tmp_path / "work" / "bart_params.pt", weights_only=True)
    sd = load_state_dict(hf_dir)
    conv = convert_hf_bart_state_dict(sd, decoder_layers=infer_decoder_layers(sd))
    assert saved.keys() == conv.keys()
    assert all(torch.equal(saved[k], conv[k]) for k in saved)


def test_train_hands_cli_train_the_jax_argv(tmp_path, hf_dir, capsys, monkeypatch):  # noqa: F811
    """``--train`` after parity: the port calls its ``cli.train.main`` with
    the JAX chain's arguments (its converted file for the orbax directory)
    plus ``--device``; parity itself is replaced by a passing report here,
    as the test above runs it."""
    import imagined_speech_translation_tpu.cli.train as jax_train
    import imagined_speech_translation_tpu_torch.cli.train as port_train

    data = _local_artifacts(tmp_path)
    argvs = {}
    for name, mod, train_mod in (("port", reproduce, port_train),
                                 ("jax", jax_reproduce, jax_train)):
        work = tmp_path / name
        (work / "bart_params").mkdir(parents=True)  # the JAX chain's converted output
        torch.save({}, work / "bart_params.pt")  # the port's
        monkeypatch.setattr(mod, "parity_report",
                            lambda *a, **k: {"identity": 1.0, "cases": []})
        monkeypatch.setattr(train_mod, "main", lambda argv, n=name: argvs.setdefault(n, argv))
        argv = ["--work-dir", str(work), "--data-dir", str(data), "--hf-checkpoint",
                str(hf_dir), "--train"]
        assert mod.main(argv + (["--device", "cpu"] if name == "port" else [])) == 0
        assert _last_json(capsys)["status"] == "ok"
    want = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in argvs["jax"]]
    want[want.index("--bart-params") + 1] += ".pt"
    assert argvs["port"] == want + ["--device", "cpu"]
    assert np.all([isinstance(a, str) for a in argvs["port"]])
