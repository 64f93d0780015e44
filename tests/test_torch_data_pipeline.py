"""The port's jax-free copies of the host data plane, the evaluator and the
metric loggers give the same outputs as the JAX package's originals on the
same inputs: the dataset's batches (augmentation on, two epochs) and split,
the robust scaler, the synthetic corpus's files, the generation metrics
with and without jieba/nltk/rouge_score, the JSONL logger, the learning
rates that the trainer logs and the region weights of its evaluation.
Everything is compared for equality, except the region weights (a softmax
in each framework, within 1e-6 relative)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu import config as jax_config
from imagined_speech_translation_tpu.data import dataset as jax_dataset
from imagined_speech_translation_tpu.data import scaler as jax_scaler
from imagined_speech_translation_tpu.data import synthetic as jax_synthetic
from imagined_speech_translation_tpu.evaluation import evaluator as jax_evaluator
from imagined_speech_translation_tpu.models.brain_encoder import BrainRegionEncoder as JaxEncoder
from imagined_speech_translation_tpu.training import optimizer as jax_optimizer
from imagined_speech_translation_tpu.utils import metrics as jax_metrics
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.data import dataset, scaler, synthetic
from imagined_speech_translation_tpu_torch.evaluation import evaluator
from imagined_speech_translation_tpu_torch.models import BrainRegionEncoder
from imagined_speech_translation_tpu_torch.training import optimizer
from imagined_speech_translation_tpu_torch.utils import metrics
from tests.helpers import build_dataset, tiny_config, tiny_tokenizer
from tests.test_torch_models import few_threads  # noqa: F401

PREDICTIONS = ["我想喝水", "请帮我打开窗户", "今天天气很好", "", "我想喝水", "hello world 音乐"]
TARGETS = ["我想喝水", "请帮我打开窗", "今天天气不错", "我需要休息", "晚饭吃什么", "hello world"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``build_dataset``'s corpus and the JAX dataset over it with
    augmentation on."""
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, augmentation=dataclasses.replace(cfg.data.augmentation, enabled=True)))
    root = tmp_path_factory.mktemp("pipeline")
    build_dataset(root, tok, cfg)
    theirs = jax_dataset.EEGTextDataset(str(root / "data"), str(root / "montage.csv"), tok,
                                        cfg.data, augment=True, seed=42)
    return root, tok, cfg, theirs


def _port_dataset(root, tok, cfg):
    data_cfg = config.Config.from_json(cfg.to_json()).data
    return dataset.EEGTextDataset(str(root / "data"), str(root / "montage.csv"), tok,
                                  data_cfg, augment=True, seed=42)


@pytest.mark.parametrize("epoch", [0, 1])
def test_get_batch_copy_matches(corpus, epoch):
    root, tok, cfg, theirs = corpus
    ours = _port_dataset(root, tok, cfg)
    assert len(ours) == len(theirs) and ours.n_timepoints == theirs.n_timepoints
    idx = np.array([3, 0, 7, 11, 5])
    got, want = ours.get_batch(idx, epoch=epoch), theirs.get_batch(idx, epoch=epoch)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # augmentation is on: the epochs draw differently
    other = ours.get_batch(idx, epoch=epoch + 1)["eeg"]
    assert not np.array_equal(other, got["eeg"])


def test_dataset_stats_copy_match(corpus):
    root, tok, cfg, theirs = corpus
    assert _port_dataset(root, tok, cfg).stats(sample_size=6) == theirs.stats(sample_size=6)


@pytest.mark.parametrize("n, seed", [(12, 42), (80, 0), (7, 3)])
def test_split_indices_copy_matches(n, seed):
    for split in ((0.8, 0.1, 0.1), (0.6, 0.2, 0.2)):
        for a, b in zip(dataset.split_indices(n, split, seed),
                        jax_dataset.split_indices(n, split, seed)):
            np.testing.assert_array_equal(a, b)


def test_scaler_copy_matches(tmp_path):
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 16), bool)
    for r, c in enumerate((16, 9, 11, 12)):
        mask[r, :c] = True
    samples = (rng.normal(size=(6, 4, 16, 50)) * 3 + 1).astype(np.float32)
    samples[:, 2, 3] = 5.0  # a constant channel: zero scale -> 1
    ours = scaler.RegionRobustScaler(quantile_range=(5.0, 95.0)).fit(samples, mask)
    theirs = jax_scaler.RegionRobustScaler(quantile_range=(5.0, 95.0)).fit(samples, mask)
    np.testing.assert_array_equal(ours.center_, theirs.center_)
    np.testing.assert_array_equal(ours.scale_, theirs.scale_)
    x = samples[0]
    np.testing.assert_array_equal(ours.transform(x), theirs.transform(x))
    np.testing.assert_array_equal(ours.inverse_transform(x), theirs.inverse_transform(x))
    ours.save(tmp_path / "ours.json")
    theirs.save(tmp_path / "theirs.json")
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    back = scaler.RegionRobustScaler.load(tmp_path / "theirs.json")
    np.testing.assert_array_equal(back.transform(x), theirs.transform(x))


@pytest.mark.parametrize("mode", [False, True, "relational", "coupled", "echo"])
def test_synthetic_corpus_copy_matches(tmp_path, mode):
    labels = synthetic.make_synthetic_montage(tmp_path / "ours.csv")
    assert labels == jax_synthetic.make_synthetic_montage(tmp_path / "theirs.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()
    kw = dict(n_files=2, samples_per_file=3, n_timepoints=384, seed=5,
              class_conditioned=mode, montage_labels=labels)
    ours = synthetic.make_synthetic_corpus(tmp_path / "ours", **kw)
    theirs = jax_synthetic.make_synthetic_corpus(tmp_path / "theirs", **kw)
    assert [p.name for p in ours] == [p.name for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes(), a.name


@pytest.mark.parametrize("fallbacks", [False, True], ids=["libraries", "fallbacks"])
def test_evaluator_copy_matches(monkeypatch, fallbacks):
    if fallbacks:
        for mod in (evaluator, jax_evaluator):
            for flag in ("_HAS_JIEBA", "_HAS_NLTK", "_HAS_ROUGE"):
                monkeypatch.setattr(mod, flag, False)
    else:
        assert jax_evaluator._HAS_JIEBA and jax_evaluator._HAS_NLTK and jax_evaluator._HAS_ROUGE
    ours = evaluator.ChineseEvaluator().compute_all_metrics(PREDICTIONS, TARGETS)
    theirs = jax_evaluator.ChineseEvaluator().compute_all_metrics(PREDICTIONS, TARGETS)
    assert ours == theirs
    assert ours["bleu_1"] > 0
    for preds in (PREDICTIONS, ["同样"] * 5, []):
        assert (evaluator.prediction_diversity(preds, min_diversity=0.3)
                == jax_evaluator.prediction_diversity(preds, min_diversity=0.3))


def test_jsonl_logger_copy_matches(tmp_path):
    records = [({"train/loss": 1.5, "train/lr": np.float32(3e-4)}, 3),
               ({"val/bleu_4": np.float64(0.25), "epoch": np.int64(1)}, None)]
    lines = {}
    for name, mod in (("ours", metrics), ("theirs", jax_metrics)):
        lg = mod.get_logger(tmp_path / name, config={"a": (1, 2)}, use_wandb=False)
        assert isinstance(lg, mod.JsonlLogger)
        for rec, step in records:
            lg.log(rec, step=step)
        lg.log_table("val/examples", ["epoch", "prediction"], [(0, "我")])
        lg.finish()
        rows = [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").open()]
        lines[name] = [{k: v for k, v in r.items() if k != "_t"} for r in rows]
    assert lines["ours"] == lines["theirs"]
    assert len(lines["ours"]) == 4
    assert isinstance(metrics.get_logger(None, use_wandb=False), metrics.NullLogger)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_learning_rates_at_copy_matches(schedule):
    opt = dataclasses.replace(jax_config.OptimizerConfig(), warmup_steps=10, schedule=schedule)
    ours_cfg = config.OptimizerConfig(**dataclasses.asdict(opt))
    total = 40
    for step in (0, 4, 10, 23, total - 1, total):
        got = optimizer.learning_rates_at(ours_cfg, total, step)
        want = jax_optimizer.learning_rates_at(opt, total, step)
        assert got == want, step


def test_build_optimizer_takes_either_form():
    names = ["model.brain_encoder.x", "model.eeg_to_bart_fc.weight", "model.bart.y", "loss_heads.z"]
    for fused in (True, False):
        cfg = dataclasses.replace(config.OptimizerConfig(), fused=fused)
        opt = optimizer.build_optimizer({n: None for n in names}, cfg, 10)
        assert isinstance(opt, optimizer.FusedAdamW)
        assert list(opt.labels.values()) == ["encoder", "projection", "bart", "projection"]


@pytest.mark.parametrize("uniform", [False, True])
def test_region_weights_match(uniform):
    tok = tiny_tokenizer()
    cfg = config.Config.from_json(tiny_config(tok.vocab_size).to_json())
    enc_cfg = dataclasses.replace(cfg.model.brain_encoder, uniform_region_weight=uniform)
    enc = BrainRegionEncoder(enc_cfg, in_channels=16, n_timepoints=64)
    params = {}
    if not uniform:
        w = np.random.default_rng(1).normal(size=4).astype(np.float32)
        with torch.no_grad():
            enc.region_importance.copy_(torch.from_numpy(w))
        params["region_importance"] = w
    jax_cfg = jax_config.Config.from_json(cfg.to_json()).model.brain_encoder
    jax_cfg = dataclasses.replace(jax_cfg, uniform_region_weight=uniform)
    got, want = enc.region_weights(), JaxEncoder.region_weights(params, jax_cfg)
    assert got["names"] == want["names"] and got["has_dynamic"] == want["has_dynamic"]
    np.testing.assert_allclose(got["softmax"], want["softmax"], rtol=1e-6)
