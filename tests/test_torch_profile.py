"""The profile script's trace arithmetic, its synthetic serving inputs
(the vocab and montage that ``chip_smoke.py`` also decodes with) and its
serving dtype flag."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.config import default_config
from imagined_speech_translation_tpu_torch.cli import profile_slice
from imagined_speech_translation_tpu_torch.cli.profile_slice import (
    device_summary,
    synthetic_montage,
    synthetic_vocab,
)
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, RegionSpec
from imagined_speech_translation_tpu_torch.data.regions import ELECTRODE_REGIONS
from tests.test_torch_models import few_threads  # noqa: F401


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_summary_merges_overlapping_device_intervals():
    events = [
        _ev("cpu_op", "aten::mm", 0.0, 1000.0),  # host span 0-1000 us
        _ev("kernel", "gemm", 100.0, 200.0),  # 100-300
        _ev("kernel", "gemm", 250.0, 100.0),  # 250-350, overlaps the first
        _ev("gpu_memcpy", "Memcpy HtoD", 320.0, 10.0),  # inside 250-350
        _ev("kernel", "flash_fwd", 600.0, 300.0),  # 600-900
        _ev("kernel", "flash_fwd", 650.0, 50.0),  # inside 600-900
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5000.0},  # not a span
    ]
    s = device_summary(events)
    assert s["span_ms"] == pytest.approx(1.0)
    assert s["busy_ms"] == pytest.approx(0.25 + 0.3)
    assert s["idle_share"] == pytest.approx(1 - 0.55)
    assert s["launches"] == 4
    assert [(n, round(ms, 6), c) for n, ms, c in s["by_name"]] == [
        ("flash_fwd", 0.35, 2), ("gemm", 0.3, 2), ("Memcpy HtoD", 0.01, 1)]


def test_device_summary_refuses_a_trace_without_device_activity():
    with pytest.raises(RuntimeError, match="no device activity"):
        device_summary([_ev("cpu_op", "aten::mm", 0.0, 10.0)])


def test_synthetic_inputs_fit_the_full_width_config():
    cfg = default_config()
    vocab = synthetic_vocab(cfg.model.bart.vocab_size)
    tok = ChineseCharTokenizer(vocab)
    assert tok.vocab_size == cfg.model.bart.vocab_size == len(set(vocab))
    assert (tok.pad_token_id, tok.vocab["[UNK]"], tok.bos_token_id, tok.sep_token_id) == (
        0, 100, 101, 102)
    labels = synthetic_montage()
    assert len(labels) == 125 and labels == synthetic_montage()
    spec = RegionSpec.from_channel_names(labels)
    counts = [len(r) for r in ELECTRODE_REGIONS.values()]
    np.testing.assert_array_equal(spec.channel_mask.sum(axis=1), counts)
    assert np.array_equal(np.sort(spec.gather_indices[spec.channel_mask]),
                          np.sort([labels.index(ch) for r in ELECTRODE_REGIONS.values()
                                   for ch in r]))


@pytest.mark.parametrize("argv, want", [
    ([], torch.bfloat16),
    (["--compute-dtype", "float32"], torch.float32),
])
def test_compute_dtype_reaches_build_decode_fn(monkeypatch, argv, want):
    """``--compute-dtype`` (bfloat16 unless given) is the dtype the serving
    batch is built in; the card and the model are stubbed, and the run
    stops at ``build_decode_fn``."""
    seen = {}

    class Built(Exception):
        pass

    def build_decode_fn(*args, **kw):
        seen.update(kw)
        raise Built

    monkeypatch.setattr(profile_slice.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profile_slice.subprocess, "run",
                        lambda *a, **kw: SimpleNamespace(stdout="NVIDIA H100, 700.00 W\n"))
    monkeypatch.setattr(profile_slice, "build_model", lambda *a, **kw: None)
    monkeypatch.setattr(profile_slice, "build_decode_fn", build_decode_fn)
    with pytest.raises(Built):
        profile_slice.main(argv)
    assert seen["compute_dtype"] is want and seen["fold_bn"]


@pytest.mark.parametrize("argv, mixed", [
    (["--what", "train"], True),
    (["--what", "train", "--compute-dtype", "bfloat16"], True),
    (["--what", "train", "--compute-dtype", "float32"], False),
])
def test_compute_dtype_reaches_the_training_config(monkeypatch, argv, mixed):
    """``--what train --compute-dtype float32`` builds the step with
    ``training.mixed_precision=False`` (bfloat16, the default, keeps it on);
    the card is stubbed, and the run stops where the module is built."""
    seen = {}

    class Built(Exception):
        pass

    def build_train_module(cfg, *args, **kw):
        seen["cfg"] = cfg
        raise Built

    monkeypatch.setattr(profile_slice.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profile_slice.subprocess, "run",
                        lambda *a, **kw: SimpleNamespace(stdout="NVIDIA H100, 700.00 W\n"))
    monkeypatch.setattr(profile_slice, "build_train_module", build_train_module)
    with pytest.raises(Built):
        profile_slice.main(argv)
    assert seen["cfg"].training.mixed_precision is mixed
    assert seen["cfg"].model == profile_slice.default_config().model
