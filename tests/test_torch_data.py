"""The port's jax-free copies of ``data/regions.py`` and ``data/tokenizer.py``
give the same outputs as the JAX package's originals."""

import numpy as np
import pytest

from imagined_speech_translation_tpu.data import regions as jax_regions
from imagined_speech_translation_tpu.data import tokenizer as jax_tokenizer
from imagined_speech_translation_tpu.data.synthetic import make_synthetic_montage
from imagined_speech_translation_tpu_torch.data import regions, tokenizer
from tests.helpers import TINY_VOCAB

TEXTS = ["我想喝水", "请帮我打开窗户。", "hello, world", "HeLLo  今天\t天气很好!", "", "未知字符"]


def test_regions_copy_matches(tmp_path):
    labels = make_synthetic_montage(tmp_path / "m.csv")
    assert regions.load_montage(tmp_path / "m.csv") == jax_regions.load_montage(tmp_path / "m.csv")
    assert regions.ELECTRODE_REGIONS == jax_regions.ELECTRODE_REGIONS
    assert regions.REGION_NAMES == jax_regions.REGION_NAMES
    assert regions.get_electrode_regions() == jax_regions.get_electrode_regions()
    assert regions.build_region_indices(labels) == jax_regions.build_region_indices(labels)
    ours = regions.RegionSpec.from_channel_names(labels)
    theirs = jax_regions.RegionSpec.from_channel_names(labels)
    for field in ("region_names", "counts", "max_channels", "total_channels"):
        assert getattr(ours, field) == getattr(theirs, field)
    np.testing.assert_array_equal(ours.gather_indices, theirs.gather_indices)
    np.testing.assert_array_equal(ours.channel_mask, theirs.channel_mask)
    eeg = np.random.default_rng(0).normal(size=(len(labels), 33)).astype(np.float32)
    np.testing.assert_array_equal(ours.stack(eeg), theirs.stack(eeg))
    for a, b in zip(ours.split(ours.stack(eeg)), theirs.split(theirs.stack(eeg))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="No channels"):
        regions.RegionSpec.from_channel_names(["AUX0"])


def test_tokenizer_copy_matches(tmp_path):
    vocab = list(dict.fromkeys(TINY_VOCAB))
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    ours = tokenizer.ChineseCharTokenizer.from_vocab_file(path, eos_token="[EOS]")
    theirs = jax_tokenizer.ChineseCharTokenizer.from_vocab_file(path, eos_token="[EOS]")
    for attr in ("vocab_size", "pad_token_id", "bos_token_id", "eos_token_id",
                 "sep_token_id", "special_ids"):
        assert getattr(ours, attr) == getattr(theirs, attr)
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text)
        for fn in ("encode", "encode_for_seq2seq"):
            a, b = getattr(ours, fn)(text, 10), getattr(theirs, fn)(text, 10)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    ids = np.random.default_rng(1).integers(-1, len(vocab) + 3, (5, 12))
    assert ours.batch_decode(ids) == theirs.batch_decode(ids)
    assert ours.batch_decode(ids, skip_special_tokens=False) == theirs.batch_decode(
        ids, skip_special_tokens=False
    )
