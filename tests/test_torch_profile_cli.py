"""The port's ``cli/profile.py`` and what it needs: ``cross_entropy_loss``
and ``utils.profiling`` against the JAX package, the ``train`` program's
gradients against the JAX script's, and the script itself on the CPU.

Tolerances: the loss within 1e-6 (float32 log-softmax of a small vocab);
the gradients per parameter within 1e-4 of the largest entry of the JAX
gradient (a float32 forward and backward a few hundred operations deep,
summed in other orders) plus 1e-7, for the gradients that are zero up to
rounding (a key projection's bias, which softmax cancels, is ~1e-9).
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu import config as jax_config
from imagined_speech_translation_tpu.cli import profile as jax_profile
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.models.bart import cross_entropy_loss as jax_ce
from imagined_speech_translation_tpu.utils import profiling as jax_profiling
from imagined_speech_translation_tpu_torch.cli import profile
from imagined_speech_translation_tpu_torch.convert import convert_variables, load_flax_variables
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from imagined_speech_translation_tpu_torch.models.bart import cross_entropy_loss
from imagined_speech_translation_tpu_torch.utils import profiling
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_models import few_threads  # noqa: F401


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("ignored", ["some", "all"])
def test_cross_entropy_loss_matches_jax(smoothing, ignored):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7))
    if ignored == "all":
        labels[:] = -100
    else:
        labels[1, 4:] = -100
        labels[2, 0] = -100
    want, n_want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), label_smoothing=smoothing)
    got, n_got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                    label_smoothing=smoothing)
    assert int(n_got) == int(n_want) == (0 if ignored == "all" else 17)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(tmp_path / "t") as path:
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == tmp_path / "t" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_region" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)


def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 6.0, 6.0, 10.0] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    results = []
    for mod in (jax_profiling, profiling):
        timer = mod.StepTimer(warmup=2)
        seen = []
        for _ in range(4):
            with timer:
                pass
            seen.append((timer.mean_s, timer.throughput(8)))
        results.append(seen)
    assert results[0] == results[1] == [(None, None), (None, None), (3.0, 8 / 3), (3.5, 8 / 3.5)]


def _jax_tiny_overrides():
    """The ``--tiny`` overrides as the JAX script lists them."""
    tree = ast.parse(Path(jax_profile.__file__).read_text())
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For)
                and isinstance(n.iter, ast.Tuple))
    return tuple(ast.literal_eval(e) for e in loop.iter.elts)


def test_tiny_overrides_are_the_jax_scripts():
    assert profile.TINY_OVERRIDES == _jax_tiny_overrides()
    jcfg = jax_config.default_config()
    for path, value in _jax_tiny_overrides():
        jcfg = jax_config.replace_nested(jcfg, path, value)
    assert dataclasses.asdict(profile.profile_config(tiny=True)) == dataclasses.asdict(jcfg)


def test_train_program_gradients_match_the_jax_script():
    cfg = profile.profile_config(tiny=True)
    inputs = profile.profile_inputs(cfg, 2, "cpu")
    eeg, ids, labels, mask = (inputs[k].numpy() for k in ("eeg", "ids", "labels", "mask"))
    jm = JaxModel(cfg.model)
    variables = seeded_flax_variables(jm, eeg, ids, mask, seed=3)

    # cli/profile.py's train program, as the JAX script writes it
    @jax.jit
    def step(v, e, i, lab):
        def loss_fn(p):
            logits = jm.apply({"params": p, "batch_stats": v.get("batch_stats", {})}, e, i, mask)
            return jax_ce(logits, lab)[0]

        return jax.grad(loss_fn)(v["params"])

    jgrads = jax.tree_util.tree_map(np.asarray, step(variables, eeg, ids, labels))
    want = convert_variables({"params": jgrads, "batch_stats": variables["batch_stats"]},
                             EEGDecodingModel(cfg.model, cfg.data.n_timepoints))

    model = load_flax_variables(EEGDecodingModel(cfg.model, cfg.data.n_timepoints), variables)
    grads = profile.build_program("train", model.eval(), cfg, inputs)()
    names = [n for n, _ in model.named_parameters()]
    assert len(grads) == len(names) > 100
    for name, g in zip(names, grads):
        w = want[name]
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item() + 1e-7, name


@pytest.mark.parametrize("what", ["encode", "generate", "train"])
def test_profile_script_runs_on_the_cpu(tmp_path, what):
    res = profile.main(["--tiny", "--device", "cpu", "--iters", "1", "--batch", "2",
                        "--what", what, "--out", str(tmp_path)])
    assert res["trace"] == tmp_path / "trace.json" and len(res["seconds"]) == 1
    events = json.loads(res["trace"].read_text())["traceEvents"]
    assert any(e.get("name") == f"{what}_0" for e in events)
    out = res["out"]
    if what == "encode":
        assert out[0].shape == (2, 48) and out[1].shape[::2] == (2, 48)
    elif what == "generate":
        assert out.shape == (2, 16) and out.min() >= 0 and out.max() < 256
    else:
        assert len(out) > 100 and all(torch.isfinite(g).all() for g in out)
