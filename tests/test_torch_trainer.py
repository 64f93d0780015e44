"""The port's trainer path against the JAX package's: the eval step under
mixed precision, ``EEGTrainer`` over two epochs, checkpoints, resume and
the ``cli.train`` / ``cli.evaluate`` scripts.

Sizes: ``tests.helpers.tiny_config`` (hidden 48, 2 decoder layers, T = 64,
micro-batch 2, accumulation 2, beam 2 to length 10) on ``build_dataset``'s
synthetic corpus (3 files x 4 samples).

The trainer parity run starts both trainers from the JAX trainer's initial
weights (converted with ``convert.load_flax_variables``), with dropout
neutralised in both packages as ``tests/test_torch_train_step.py`` does
(the bits cannot agree), for two epochs of two windows, each followed by an
evaluation of three validation samples (a padded tail batch) and a
checkpoint.  Tolerances (float32): per-window train losses and each
evaluation's losses within 1e-4 relative; predictions, model-selection
decisions and checkpoint names identical.  The eval step under mixed
precision runs in float32 in both packages: within 1e-4 relative.
Port-only runs (dropout on) are compared bit for bit: a checkpoint against
the state it was saved from, and a resumed run against an uninterrupted
one.
"""

import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.training import EEGTrainer as JaxTrainer
from imagined_speech_translation_tpu.training import TrainModule as JaxTrainModule
from imagined_speech_translation_tpu.training import TrainState as JaxTrainState
from imagined_speech_translation_tpu.training import get_top_k_vocab_indices as jax_bow
from imagined_speech_translation_tpu.training import make_eval_step as jax_make_eval_step
from imagined_speech_translation_tpu.utils.metrics import JsonlLogger as JaxJsonlLogger
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import evaluate as evaluate_cli
from imagined_speech_translation_tpu_torch.cli import train as train_cli
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, EEGTextDataset
from imagined_speech_translation_tpu_torch.training import (
    AdaptiveLossScheduler,
    CheckpointManager,
    EEGTrainer,
    FusedAdamW,
    TrainModule,
    create_train_state,
    get_top_k_vocab_indices,
    make_eval_step,
)
from imagined_speech_translation_tpu_torch.utils import JsonlLogger
from tests.helpers import TINY_VOCAB, build_dataset, tiny_config, tiny_tokenizer
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_train_step import BOW, _batch, _no_dropout_jax, _no_dropout_port
from tests.test_torch_models import few_threads  # noqa: F401

TRAIN, VAL = np.arange(8), np.array([8, 9, 10])
COMPONENTS = ("loss_ce", "loss_align", "loss_bow", "loss_div", "loss_var")


def _jax_cfg():
    cfg = tiny_config(tiny_tokenizer().vocab_size)
    tc = cfg.training
    return cfg.replace(training=dataclasses.replace(
        tc, checkpoint=dataclasses.replace(tc.checkpoint, save_interval_epochs=1,
                                           max_to_keep=1)))


def _port(cfg):
    return config.Config.from_json(cfg.to_json())


def _port_tokenizer():
    return ChineseCharTokenizer(list(dict.fromkeys(TINY_VOCAB)), eos_token="[EOS]")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_corpus")
    jax_cfg = _jax_cfg()
    jax_ds = build_dataset(root, tiny_tokenizer(), jax_cfg)
    return root, jax_cfg, jax_ds


def _port_dataset(root, cfg, tok):
    return EEGTextDataset(str(root / "data"), str(root / "montage.csv"), tok, cfg.data,
                          augment=False, seed=42)


def _port_trainer(root, cfg, out, device="cpu", **kw):
    tok = _port_tokenizer()
    return EEGTrainer(
        cfg, _port_dataset(root, cfg, tok), tok,
        bow_indices=get_top_k_vocab_indices(tok, cfg.training.loss.bow_vocab_size),
        train_indices=TRAIN, val_indices=VAL, checkpoint_dir=str(out / "ckpt"),
        device=device, **kw)


def _recording(trainer):
    """Keep every evaluation's metrics in ``trainer.evals``."""
    trainer.evals = []
    evaluate = trainer.evaluate

    def record(state, *, epoch=0):
        out = evaluate(state, epoch=epoch)
        trainer.evals.append(out)
        return out

    trainer.evaluate = record
    return trainer


def _train_losses(path):
    rows = [json.loads(line) for line in path.open()]
    return [(r["_step"], r["train/loss"]) for r in rows if "train/loss" in r]


@pytest.fixture(scope="module")
def parity(corpus, tmp_path_factory):
    """Two epochs of the JAX trainer and of the port's from the same
    initial weights, dropout off in both."""
    root, jax_cfg, jax_ds = corpus
    out = tmp_path_factory.mktemp("trainer_parity")
    tok = tiny_tokenizer()
    bow = jax_bow(tok, jax_cfg.training.loss.bow_vocab_size)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_jax(mp)
        jt = _recording(JaxTrainer(
            jax_cfg, jax_ds, tok, bow_indices=bow, train_indices=TRAIN, val_indices=VAL,
            metric_logger=JaxJsonlLogger(out / "jax" / "metrics.jsonl"),
            checkpoint_dir=str(out / "jax" / "ckpt")))
        jstate = jt.init_state(jax.random.key(0))
        # the JAX step donates its input state: copy the weights out first
        variables = {"params": jax.tree.map(np.array, jstate.params),
                     "batch_stats": jax.tree.map(np.array, jstate.batch_stats)}
        jt.train(jstate)
    cfg = _port(jax_cfg)
    pt = _recording(_port_trainer(root, cfg, out / "port",
                                  metric_logger=JsonlLogger(out / "port" / "metrics.jsonl")))
    assert list(pt.bow_indices) == list(bow)
    state = pt.init_state(0)
    load_flax_variables(state.module, variables)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_port(mp)
        state, _ = pt.train(state)
    return dict(out=out, jax=jt, port=pt, state=state)


def test_trainer_train_losses_match_jax(parity):
    out = parity["out"]
    want, got = _train_losses(out / "jax" / "metrics.jsonl"), _train_losses(
        out / "port" / "metrics.jsonl")
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)
    assert parity["state"].step == 4


@pytest.mark.parametrize("epoch", [0, 1])
def test_trainer_evaluation_matches_jax(parity, epoch):
    want, got = parity["jax"].evals[epoch], parity["port"].evals[epoch]
    for k in ("val_loss",) + COMPONENTS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["predictions"] == want["predictions"] and len(got["predictions"]) == len(VAL)
    assert got["targets"] == want["targets"]
    for k, v in want.items():
        if k.startswith(("bleu", "rouge", "token_", "diversity", "unique", "total_", "is_")):
            assert got[k] == v, k
        elif k.startswith("region_weight_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)


def test_trainer_model_selection_matches_jax(parity):
    jt, pt = parity["jax"], parity["port"]
    for attr in ("best_bleu4", "best_diversity", "patience_counter", "consecutive_repetitive"):
        assert getattr(pt, attr) == getattr(jt, attr), attr
    names = {p.name for p in (parity["out"] / "port" / "ckpt").iterdir()}
    assert names == {p.name for p in (parity["out"] / "jax" / "ckpt").iterdir()}
    assert "checkpoint_epoch_2" in names and "checkpoint_epoch_1" not in names
    w_got, w_want = pt.adaptive.get_weights(), jt.adaptive.get_weights()
    assert set(w_got) == set(w_want)
    for k in w_want:
        np.testing.assert_allclose(w_got[k], w_want[k], rtol=1e-4, err_msg=k)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert a.loss_weights == b.loss_weights
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert set(sa) == set(sb)
    for name, tensors in (("module", (sa, sb)), ("mu", (a.opt_state.mu, b.opt_state.mu)),
                          ("nu", (a.opt_state.nu, b.opt_state.nu))):
        x, y = tensors
        assert set(x) == set(y), name
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), f"{name}.{k}"


def test_checkpoint_roundtrip_bit_for_bit(parity, tmp_path):
    pt, live = parity["port"], parity["state"]
    mgr = CheckpointManager(tmp_path / "ckpt")
    meta = {"epoch": 1, "best_bleu4": 0.5}
    mgr.save_best(live, meta)
    fresh = pt.init_state(seed=7)
    assert not torch.equal(fresh.module.state_dict()["model.eeg_to_bart_fc.weight"],
                           live.module.state_dict()["model.eeg_to_bart_fc.weight"])
    restored, m2 = mgr.restore("best_model", fresh)
    assert m2 == meta
    assert restored.module is fresh.module
    assert live.opt_state.count == 4 and any(v.abs().sum() > 0 for v in live.opt_state.nu.values())
    _assert_states_equal(restored, live)


@pytest.mark.parametrize("tamper", ["missing", "extra", "shape", "dtype"])
def test_checkpoint_restore_is_strict(parity, tmp_path, tamper):
    pt, live = parity["port"], parity["state"]
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save_best(live, {})
    path = tmp_path / "ckpt" / "best_model" / "state.pt"
    saved = torch.load(path, weights_only=True)
    key = "model.eeg_to_bart_fc.bias"
    if tamper == "missing":
        del saved["module"][key]
    elif tamper == "extra":
        saved["opt_state"]["mu"]["model.no_such"] = torch.zeros(1)
    elif tamper == "shape":
        saved["module"][key] = saved["module"][key][:-1]
    else:
        saved["opt_state"]["mu"][key] = saved["opt_state"]["mu"][key].float()
    torch.save(saved, path)
    with pytest.raises((KeyError, ValueError)):
        mgr.restore("best_model", pt.init_state(seed=7))


def test_checkpoint_epoch_gc_and_latest(parity, tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_epoch_keep=2)
    assert mgr.latest_epoch_checkpoint() is None
    for e in range(4):
        mgr.save_epoch(parity["state"], e, {"epoch": e})
    names = sorted(p.name for p in (tmp_path / "ckpt").glob("checkpoint_epoch_*"))
    assert names == ["checkpoint_epoch_3", "checkpoint_epoch_4"]
    assert mgr.latest_epoch_checkpoint() == "checkpoint_epoch_4"
    assert mgr.exists("checkpoint_epoch_4") and not mgr.exists("checkpoint_epoch_1")
    _, meta = mgr.restore("checkpoint_epoch_4", parity["port"].init_state(seed=7))
    assert meta == {"epoch": 3}


def test_interrupt_checkpoint_saves_live_state(corpus, tmp_path):
    """Ctrl-C after an epoch's steps saves the live state; mid-epoch resume
    metadata records the windows done."""
    root, jax_cfg, _ = corpus
    trainer = _port_trainer(root, _port(jax_cfg), tmp_path)
    state = trainer.init_state()

    def boom(*a, **kw):
        raise KeyboardInterrupt

    trainer.evaluate = boom  # the interrupt lands after the epoch's steps
    with pytest.raises(KeyboardInterrupt):
        trainer.train(state)
    assert trainer.ckpt.exists("interrupted_checkpoint")
    restored, meta = trainer.ckpt.restore("interrupted_checkpoint", trainer.init_state(seed=1))
    assert restored.step == 2 and meta["epoch"] == 0 and meta["window"] == 2
    _assert_states_equal(restored, trainer._live_state)


def test_interrupt_inside_a_step_saves_nothing(corpus, tmp_path):
    root, jax_cfg, _ = corpus
    trainer = _port_trainer(root, _port(jax_cfg), tmp_path)
    state = trainer.init_state()
    step = trainer._train_step
    calls = []

    def interrupted_step(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return step(*a, **kw)

    trainer._train_step = interrupted_step
    with pytest.raises(KeyboardInterrupt):
        trainer.train(state)
    assert not trainer.ckpt.exists("interrupted_checkpoint")


def test_trainer_needs_a_card_unless_asked_and_one_device(corpus, tmp_path):
    root, jax_cfg, _ = corpus
    cfg = _port(jax_cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _port_trainer(root, cfg, tmp_path, device="cuda")
    many = cfg.replace(parallel=dataclasses.replace(cfg.parallel, data_axis=2))
    with pytest.raises(ValueError, match="1.7"):
        _port_trainer(root, many, tmp_path)


def test_eval_step_under_mixed_precision_matches_jax():
    """The eval step runs float32 parameters on float32 EEG whatever
    ``training.mixed_precision`` says, as the JAX package's does."""
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=124)
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, mixed_precision=True, grad_accum_dtype="bfloat16",
        loss=dataclasses.replace(cfg.training.loss, bow_vocab_size=len(BOW))))
    micro = {k: a if k == "channel_mask" else a[0] for k, a in _batch(cfg, 0).items()}
    jm = JaxTrainModule(cfg, bow_k=len(BOW))
    init = SimpleNamespace(init=functools.partial(jm.init, method="init_all"))
    v = seeded_flax_variables(init, micro["eeg"], micro["decoder_input_ids"],
                              micro["channel_mask"], seed=4)
    weights = AdaptiveLossScheduler(_port(cfg).training.loss).initial_weights()
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, v["params"]),
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=None,
        loss_weights={k: jnp.float32(w) for k, w in weights.items()},
    )
    want = jax.jit(jax_make_eval_step(jm, cfg, BOW))(
        jstate, {k: jnp.asarray(a) for k, a in micro.items()})
    pcfg = _port(cfg)
    assert pcfg.training.mixed_precision
    module = load_flax_variables(TrainModule(pcfg, bow_k=len(BOW)), v)
    state = create_train_state(
        module, FusedAdamW([n for n, _ in module.named_parameters()],
                           pcfg.training.optimizer, 10), weights)
    got = make_eval_step(module, pcfg, BOW)(
        state, {k: torch.from_numpy(a) for k, a in micro.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)


def _cli_args(root, tmp_path, cfg, *extra):
    (tmp_path / "vocab.txt").write_text("\n".join(dict.fromkeys(TINY_VOCAB)) + "\n",
                                        encoding="utf-8")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    return ["--data-dir", str(root / "data"), "--montage", str(root / "montage.csv"),
            "--vocab", str(tmp_path / "vocab.txt"), "--config", str(tmp_path / "cfg.json"),
            "--device", "cpu", *extra]


def test_cli_resume_equals_one_run_and_evaluate_agrees(corpus, tmp_path, monkeypatch):
    """``cli.train`` for 2 epochs, then ``--resume`` for a third, ends with
    the state of one 3-epoch run, bit for bit (dropout and augmentation on;
    warmup longer than the run, so both runs read the same learning rates);
    ``cli.evaluate`` of the last checkpoint gives the trainer's evaluation
    of the same weights on the same, plain windows (the trainer, as the JAX
    one, evaluates augmented windows while augmentation is on)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")  # metrics.jsonl only
    root, jax_cfg, _ = corpus
    cfg = _port(jax_cfg)
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, augmentation=dataclasses.replace(
            cfg.data.augmentation, enabled=True)),
        training=dataclasses.replace(cfg.training, optimizer=dataclasses.replace(
            cfg.training.optimizer, warmup_steps=100)))
    args = _cli_args(root, tmp_path, cfg)
    whole = train_cli.main(args + ["--out-dir", str(tmp_path / "whole"),
                                   "--set", "training.num_epochs=3"])
    first = train_cli.main(args + ["--out-dir", str(tmp_path / "split")])
    assert first["state"].step == 4
    resumed = train_cli.main(args + ["--out-dir", str(tmp_path / "split"), "--resume",
                                     "--set", "training.num_epochs=3"])
    assert resumed["trainer"].start_epoch == 2
    assert whole["state"].step == resumed["state"].step == 6
    _assert_states_equal(resumed["state"], whole["state"])
    for k in ("val_loss",) + COMPONENTS:
        assert resumed["test_metrics"][k] == whole["test_metrics"][k], k

    metrics = evaluate_cli.main(args + [
        "--checkpoint", str(tmp_path / "split" / "checkpoints" / "checkpoint_epoch_3")])
    trainer = resumed["trainer"]
    trainer.dataset.augment = False
    want = trainer.evaluate(resumed["state"])
    assert want["val_loss"] != resumed["test_metrics"]["val_loss"]
    for k in ("val_loss",) + COMPONENTS:
        np.testing.assert_allclose(metrics[k], want[k], rtol=1e-6, err_msg=k)
    assert metrics["predictions"] == want["predictions"]
    rows = [json.loads(line) for line in (tmp_path / "split" / "metrics.jsonl").open()]
    assert any(r.get("train/finished") for r in rows)
    assert sum("test/val_loss" in r for r in rows) == 2


def test_cli_defaults_to_the_card(corpus, tmp_path):
    root, jax_cfg, _ = corpus
    args = [a for a in _cli_args(root, tmp_path, _port(jax_cfg)) if a not in ("--device", "cpu")]
    if not torch.cuda.is_available():
        for cli in (train_cli, evaluate_cli):
            extra = ["--checkpoint", str(tmp_path / "none")] if cli is evaluate_cli else []
            with pytest.raises(SystemExit, match="--device cpu"):
                cli.main(args + extra)
