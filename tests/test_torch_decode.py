"""Port greedy / beam search vs the JAX package: token-identical generate on
the same converted weights, and the search bookkeeping alone (ties, length
penalty, early stopping, min length) on a scripted step function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams
from imagined_speech_translation_tpu.decode import build_generate_fn as jax_build_generate_fn
from imagined_speech_translation_tpu.decode.search import beam_search as jax_beam_search
from imagined_speech_translation_tpu.decode.search import greedy_search as jax_greedy_search
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.decode import (
    DecodeParams,
    beam_search,
    build_generate_fn,
    greedy_search,
)
from imagined_speech_translation_tpu_torch.decode.search import _top_k
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from tests.helpers import tiny_config, tiny_tokenizer
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_models import few_threads  # noqa: F401

T = 64


@pytest.fixture(scope="module")
def models():
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=T)
    rng = np.random.default_rng(0)
    eeg = rng.normal(size=(3, 4, 16, T)).astype(np.float32)
    mask = np.ones((4, 16), bool)
    jm = JaxModel(cfg.model)
    variables = seeded_flax_variables(jm, eeg, np.zeros((3, 4), np.int32), mask, seed=0)
    tm = load_flax_variables(EEGDecodingModel(cfg.model, T).eval(), variables)
    return cfg, tok, jm, variables, tm, eeg, mask


@pytest.mark.parametrize("num_beams", [1, 3])
def test_generate_tokens_match_jax(models, num_beams):
    cfg, tok, jm, variables, tm, eeg, mask = models
    kw = dict(max_length=10, min_length=2, num_beams=num_beams, pad_token_id=tok.pad_token_id,
              eos_token_id=tok.sep_token_id, decoder_start_token_id=tok.bos_token_id)
    want = np.asarray(jax_build_generate_fn(jm, JaxDecodeParams(**kw))(variables, eeg, mask))
    got = build_generate_fn(tm, DecodeParams(**kw))(torch.from_numpy(eeg), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_breaks_ties_like_lax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 997)).astype(np.float32)
    x[0, 10] = x[0, 500]
    x[1, :8] = 3.25
    x[2, 7] = -1e9
    x[3, :] = 0.0
    for k in (1, 3, 6, 9):
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        v, i = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(lv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(li))


V, B = 11, 3


def _scripted_steps(seed):
    """The same scripted model for both frameworks: logits from a quantized
    table (exact ties) by (position, last token), plus a per-row history
    carried in the cache, so beam reordering must gather it."""
    rng = np.random.default_rng(seed)
    table = (np.round(rng.normal(size=(16, V, V)) * 4) / 4).astype(np.float32)
    mix = (np.round(rng.normal(size=(V, V)) * 4) / 8).astype(np.float32)

    def jax_step(tokens, positions, caches):
        logits = jnp.asarray(table)[positions[:, 0], tokens[:, 0]] + caches[0]["h"]
        h = caches[0]["h"] * 0.5 + jnp.asarray(mix)[tokens[:, 0]]
        return logits[:, None], [{"h": h}]

    def torch_step(tokens, positions, caches):
        logits = torch.from_numpy(table)[positions[:, 0], tokens[:, 0]] + caches[0]["h"]
        caches[0]["h"] = caches[0]["h"] * 0.5 + torch.from_numpy(mix)[tokens[:, 0]]
        return logits[:, None]

    return jax_step, torch_step


@pytest.mark.parametrize(
    "num_beams, length_penalty, early_stopping, min_length, seed",
    [(1, 1.0, True, 3, 0), (2, 1.0, True, 1, 1), (3, 1.0, True, 4, 2),
     (3, 0.6, False, 2, 3), (4, 1.5, False, 5, 4), (3, 1.0, True, 16, 5)],
)
def test_search_bookkeeping_matches_jax(num_beams, length_penalty, early_stopping,
                                        min_length, seed):
    params = dict(max_length=12, min_length=min_length, num_beams=num_beams,
                  length_penalty=length_penalty, early_stopping=early_stopping,
                  pad_token_id=0, eos_token_id=2, decoder_start_token_id=1)
    jax_step, torch_step = _scripted_steps(seed)
    rows = B * num_beams
    h0 = np.zeros((rows, V), np.float32)
    jax_search, torch_search = (
        (jax_beam_search, beam_search) if num_beams > 1 else (jax_greedy_search, greedy_search)
    )
    want = jax.jit(lambda c: jax_search(jax_step, c, B, JaxDecodeParams(**params)))(
        [{"h": jnp.asarray(h0)}]
    )
    got = torch_search(torch_step, [{"h": torch.from_numpy(h0)}], B,
                       DecodeParams(**params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_params_match_jax_fields():
    ours = [(f.name, f.default) for f in dataclasses.fields(DecodeParams)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxDecodeParams)]
    assert ours == theirs
