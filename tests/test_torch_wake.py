"""The port's wake twin (``imagined_speech_translation_tpu_torch.wake``) and
``cli.wake_train`` against the JAX package's.

* ``WakeMLP`` on converted weights equals JAX's at T = 64 and at the odd
  T = 67 (floor pooling), logits within 1e-5 and the same predictions;
* five Adam steps from the same weights equal ``optax.adam``'s: losses
  within 1e-5 relative, parameters within 1e-5;
* the twin's own init is flax's truncated lecun-normal with zero biases;
* the twin learns ``tests/test_wake.py``'s impulse task as JAX's does;
* ``cli.wake_train --device cpu`` on ``tests/test_wake_dataset.py``'s
  corpus trains on exactly the JAX CLI's batches (standardised features,
  clipped labels, each epoch's permutation, the remainder dropped) and
  writes a ``torch.save`` file that reloads;
* the jax-free copies (``wake/dataset.py``, ``wake/native.py``,
  ``data/fetch.py``) are the originals' code, and ``wake`` exports the
  JAX package's names.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_translation_tpu.wake as jax_wake
from imagined_speech_translation_tpu.cli import wake_train as jax_wake_train
from imagined_speech_translation_tpu_torch import wake
from imagined_speech_translation_tpu_torch.cli import wake_train
from imagined_speech_translation_tpu_torch.wake.twin import init_wake_params, state_dict_from_flax
from tests.test_torch_models import few_threads, seeded_flax_variables  # noqa: F401
from tests.test_torch_runtime import _code
from tests.test_wake import _impulse_batch
from tests.test_wake_dataset import _write_corpus


def _pair(seq, seed=3):
    """The JAX twin with seeded weights and the port's twin loaded from them."""
    jm = jax_wake.WakeMLP(n_classes=seq)
    x = np.zeros((2, seq, 2), np.float32)
    params = seeded_flax_variables(jm, x, seed=seed)["params"]
    pm = wake.WakeMLP(seq, seq)
    pm.load_state_dict(state_dict_from_flax(params, pm), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("seq", [64, 67])
def test_twin_matches_jax(seq):
    jm, params, pm = _pair(seq)
    x, _ = _impulse_batch(4, seq, np.random.default_rng(seq))
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, seq)
    np.testing.assert_allclose(got, want, atol=1e-5)
    _, _, predict = wake.make_wake_train_step(pm)
    np.testing.assert_array_equal(predict(pm, torch.from_numpy(x)).numpy(), want.argmax(-1))


def test_adam_steps_match_optax():
    seq, lr = 64, 1e-3
    jm, params, pm = _pair(seq, seed=5)
    x, labels = _impulse_batch(16, seq, np.random.default_rng(0))
    j_init, j_step, _ = jax_wake.make_wake_train_step(jm, lr)
    _, opt_state = j_init(jax.random.key(0), jnp.asarray(x[:2]))  # zero moments
    init_fn, step_fn, _ = wake.make_wake_train_step(pm, lr)
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    model, opt = init_fn(0)
    model.load_state_dict(sd)  # in place: the optimizer holds these tensors
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    for i in range(5):
        params, opt_state, jloss = j_step(params, opt_state, jnp.asarray(x), jnp.asarray(labels))
        model, opt, loss = step_fn(model, opt, xt, lt)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    want = state_dict_from_flax(jax.tree.map(np.asarray, params), wake.WakeMLP(seq, seq))
    moved = 0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
        moved += not torch.equal(v, sd[k])
    assert moved == len(sd)


def test_init_is_flax_lecun_normal():
    a = init_wake_params(wake.WakeMLP(64, 64), 7)
    b = init_wake_params(wake.WakeMLP(64, 64), torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    for layer in (a.conv1, a.conv2, a.fc1, a.fc2):
        w, fan_in = layer.weight, layer.weight.shape[1:].numel()
        std = fan_in ** -0.5
        assert torch.count_nonzero(layer.bias) == 0
        assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(w.std().item() / std - 1) < 0.15
    # fc1 is big enough to hold the variance to the flax initializer's
    fc1 = a.fc1.weight
    assert abs(fc1.std().item() * 32 - 1) < 0.01  # fan_in 1024


def test_twin_learns_impulse_task():
    seq, n = 64, 64
    model = wake.WakeMLP(seq, seq)
    init_fn, step_fn, predict_fn = wake.make_wake_train_step(model, 3e-3)
    x, labels = _impulse_batch(n, seq, np.random.default_rng(1))
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels).long()
    model, opt = init_fn(0)
    first = None
    for _ in range(60):
        model, opt, loss = step_fn(model, opt, xt, lt)
        first = float(loss) if first is None else first
    assert float(loss) < 0.3 * first
    assert (predict_fn(model, xt).numpy() == labels).mean() > 0.8


def _recording(monkeypatch, module, make):
    """Replace ``module.make_wake_train_step`` with ``make`` whose step
    function records each batch as numpy."""
    batches = []

    def recording_make(model, lr):
        init_fn, step_fn, predict_fn = make(model, lr)

        def step(p, o, x, labels):
            batches.append((np.asarray(x.cpu() if hasattr(x, "cpu") else x),
                            np.asarray(labels.cpu() if hasattr(labels, "cpu") else labels)))
            return step_fn(p, o, x, labels)

        return init_fn, step, predict_fn

    monkeypatch.setattr(module, "make_wake_train_step", recording_make)
    return batches


def test_wake_train_cli_takes_the_jax_batches(tmp_path, monkeypatch):
    _write_corpus(tmp_path, n=5)  # 5 events, seq_len 9, labels 1..5
    argv = [str(tmp_path / "catalog.csv"), str(tmp_path), "--epochs", "3", "--batch", "2"]
    ours = _recording(monkeypatch, wake_train, wake.make_wake_train_step)
    acc = wake_train.main(argv + ["--out", str(tmp_path / "twin.pt"), "--device", "cpu"])
    theirs = _recording(monkeypatch, jax_wake, jax_wake.make_wake_train_step)
    jax_acc = jax_wake_train.main(argv + ["--out", str(tmp_path / "twin.msgpack")])
    assert len(ours) == len(theirs) == 3 * 2  # 5 // 2 batches an epoch, one row dropped
    for (x, lab), (jx, jlab) in zip(ours, theirs):
        np.testing.assert_allclose(x, jx, atol=1e-6)
        np.testing.assert_array_equal(lab, jlab)
    assert 0.0 <= acc <= 1.0 and 0.0 <= jax_acc <= 1.0
    sd = torch.load(tmp_path / "twin.pt", weights_only=True)
    model = wake.WakeMLP(9, 9)
    model.load_state_dict(sd, strict=True)
    assert all(v.device.type == "cpu" for v in sd.values())


def test_wake_train_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _write_corpus(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA card"):
        wake_train.main([str(tmp_path / "catalog.csv"), str(tmp_path), "--epochs", "1",
                         "--out", str(tmp_path / "twin.pt")])
    assert not (tmp_path / "twin.pt").exists()


@pytest.mark.parametrize("name", ["wake.dataset", "wake.native", "data.fetch"])
def test_copied_module_code_is_the_original(name):
    port = importlib.import_module(f"imagined_speech_translation_tpu_torch.{name}")
    orig = importlib.import_module(f"imagined_speech_translation_tpu.{name}")
    assert _code(port) == _code(orig)


def test_wake_package_exports_match():
    def exports(pkg):
        return {n for n in dir(pkg)
                if not n.startswith("_") and not inspect.ismodule(getattr(pkg, n))}

    assert exports(wake) == exports(jax_wake)
    # the native binding resolves the same wake_native/ from either package
    assert wake.native._NATIVE_DIR == jax_wake.native._NATIVE_DIR
