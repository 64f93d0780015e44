"""The port's pretrained-decoder path against the JAX package's: the untied
head, ``cross_attn_kv`` / ``cross_kvs=``, ``build_bart_generate_fn``, the HF
converter (``models/hf_convert.py``, ``cli/convert_hf.py`` with its own
safetensors reader), the graft (``training/pretrained.py``) and
``cli.train --bart-params`` over two epochs.

Every checkpoint is a tiny HF ``BartForConditionalGeneration`` built from a
``BartConfig`` with random weights (seed 0) at ``tests.helpers.tiny_config``'s
decoder widths (d 48, 4 heads, 2 layers, ffn 96), saved with
``save_pretrained`` as ``model.safetensors`` and as ``pytorch_model.bin``.
Its vocabulary (140) and positions (40 + 2) differ from the models' so
that the graft's overlap copy runs.

Tolerances (float32): converted and grafted tensors equal the JAX
package's bit for bit, except the mean rows that ``--vocab-size`` appends
(float32 sums in another order: within 1e-6 of the largest entry); teacher-forced logits within
1e-5 relative to their largest magnitude; generated ids identical, to JAX's
and, without a mask, to HF ``generate``'s; the two CLIs' train losses within
1e-4 relative and their predictions identical.
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

transformers = pytest.importorskip("transformers")

from imagined_speech_translation_tpu.cli import convert_hf as jax_convert_cli  # noqa: E402
from imagined_speech_translation_tpu.cli import train as jax_train_cli  # noqa: E402
from imagined_speech_translation_tpu.config import BartConfig as JaxBartConfig  # noqa: E402
from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams  # noqa: E402
from imagined_speech_translation_tpu.decode.generate import (  # noqa: E402
    build_bart_generate_fn as jax_build_bart_generate_fn,
)
from imagined_speech_translation_tpu.models import BartDecoderModel as JaxBart  # noqa: E402
from imagined_speech_translation_tpu.models import (  # noqa: E402
    convert_hf_bart_state_dict as jax_convert_hf,
)
import imagined_speech_translation_tpu.training.trainer as jax_trainer_module  # noqa: E402
from imagined_speech_translation_tpu.training import EEGTrainer as JaxTrainer  # noqa: E402
from imagined_speech_translation_tpu.training import TrainState as JaxTrainState  # noqa: E402
from imagined_speech_translation_tpu.training.pretrained import (  # noqa: E402
    graft_bart_params as jax_graft,
)
from imagined_speech_translation_tpu_torch import config  # noqa: E402
from imagined_speech_translation_tpu_torch.cli import convert_hf  # noqa: E402
from imagined_speech_translation_tpu_torch.cli import train as train_cli  # noqa: E402
from imagined_speech_translation_tpu_torch.convert import (  # noqa: E402
    convert_variables,
    load_flax_variables,
)
from imagined_speech_translation_tpu_torch.decode import (  # noqa: E402
    DecodeParams,
    beam_search,
    build_bart_generate_fn,
    greedy_search,
)
from imagined_speech_translation_tpu_torch.models import (  # noqa: E402
    BartDecoderModel,
    convert_hf_bart_state_dict,
    resize_embedding,
)
from imagined_speech_translation_tpu_torch.training import (  # noqa: E402
    AdaptiveLossScheduler,
    EEGTrainer,
    build_optimizer,
    build_train_module,
    create_train_state,
    make_train_step,
)
from imagined_speech_translation_tpu_torch.training.pretrained import (  # noqa: E402
    graft_bart_params,
)
from tests.helpers import tiny_config, tiny_tokenizer  # noqa: E402
from tests.test_torch_models import seeded_flax_variables  # noqa: E402
from tests.test_torch_train_step import (  # noqa: E402
    BOW,
    _batch,
    _no_dropout_jax,
    _no_dropout_port,
)
from tests.test_torch_trainer import TINY_VOCAB, _port, corpus  # noqa: E402,F401
from tests.test_torch_models import few_threads  # noqa: F401

HF_VOCAB, D, HEADS, LAYERS, FFN, HF_MAXPOS = 140, 48, 4, 2, 96, 40
PAD, BOS, EOS, START = 0, 1, 2, 2
B, S = 3, 4


def _hf_config():
    return transformers.BartConfig(
        vocab_size=HF_VOCAB, d_model=D, encoder_layers=1, decoder_layers=LAYERS,
        encoder_attention_heads=HEADS, decoder_attention_heads=HEADS, encoder_ffn_dim=FFN,
        decoder_ffn_dim=FFN, max_position_embeddings=HF_MAXPOS, activation_function="gelu",
        dropout=0.1, attention_dropout=0.0, pad_token_id=PAD, bos_token_id=BOS,
        eos_token_id=EOS, decoder_start_token_id=START, forced_eos_token_id=None,
        scale_embedding=False)


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """The HF model (eval mode, a nonzero ``final_logits_bias``) and its two
    save directories."""
    torch.manual_seed(0)
    model = transformers.BartForConditionalGeneration(_hf_config()).eval()
    with torch.no_grad():  # HF starts it at zero; make it count
        model.final_logits_bias.normal_(0.0, 0.5)
    root = tmp_path_factory.mktemp("hf_bart")
    model.save_pretrained(root / "st", safe_serialization=True)
    model.save_pretrained(root / "bin", safe_serialization=False)
    assert (root / "st" / "model.safetensors").exists()
    assert (root / "bin" / "pytorch_model.bin").exists()
    return SimpleNamespace(model=model, root=root)


def _bart_cfgs(vocab=HF_VOCAB, maxpos=HF_MAXPOS, tie=True):
    kw = dict(vocab_size=vocab, d_model=D, encoder_layers=S, decoder_layers=LAYERS,
              num_heads=HEADS, ffn_dim=FFN, max_position_embeddings=maxpos, pad_token_id=PAD,
              bos_token_id=BOS, eos_token_id=EOS, decoder_start_token_id=START,
              tie_word_embeddings=tie)
    return JaxBartConfig(**kw), config.BartConfig(**kw)


def _np_state_dict(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_tensors_equal(got: dict, want: dict, appended=None):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "shared.weight" and appended:  # rows [appended:] are float32 means
            torch.testing.assert_close(got[k][:appended], want[k][:appended], rtol=0, atol=0)
            torch.testing.assert_close(got[k][appended:], want[k][appended:], rtol=0,
                                       atol=1e-6 * want[k].abs().max().item())
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("tie", [True, False])
def test_bart_head_matches_jax(tie):
    """With ``tie_word_embeddings=False`` the JAX module keeps the shared
    head and has no ``final_logits_bias``; so has the port (it raised
    before)."""
    jcfg, pcfg = _bart_cfgs(tie=tie)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, HF_VOCAB, (B, 7)).astype(np.int32)
    enc = rng.normal(size=(B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, -1] = 0
    jm = JaxBart(jcfg)
    v = seeded_flax_variables(jm, ids, enc, mask, seed=2)
    assert ("final_logits_bias" in v["params"]) == tie
    port = load_flax_variables(BartDecoderModel(pcfg), v)  # convert.py takes both trees
    assert ("final_logits_bias" in port.state_dict()) == tie
    want = np.asarray(jm.apply(v, jnp.asarray(ids), jnp.asarray(enc), jnp.asarray(mask)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(enc),
                   torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_cross_kvs_decode_steps_match_jax():
    """Incremental steps with hoisted cross-attention K/V and a mask that
    hides one position: the port against JAX, and against itself without
    the hoist."""
    jcfg, pcfg = _bart_cfgs()
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, 1] = 0
    ids = rng.integers(3, HF_VOCAB, (B, 5)).astype(np.int32)
    jm = JaxBart(jcfg)
    v = seeded_flax_variables(jm, ids, enc, mask, seed=5)
    port = load_flax_variables(BartDecoderModel(pcfg), v)
    jkvs = jm.apply(v, jnp.asarray(enc), method="cross_attn_kv")
    jcaches = jm.init_cache(B, 8)
    with torch.no_grad():
        kvs = port.cross_attn_kv(torch.from_numpy(enc))
        caches, plain_caches = port.init_cache(B, 8), port.init_cache(B, 8)
        for t in range(ids.shape[1]):
            tok = ids[:, t : t + 1]
            pos = np.full((B, 1), t, np.int32)
            want, jcaches = jm.apply(v, jnp.asarray(tok), jnp.asarray(enc), jnp.asarray(mask),
                                     positions=jnp.asarray(pos), caches=jcaches,
                                     cross_kvs=jkvs)
            args = (torch.from_numpy(tok).long(), torch.from_numpy(enc), torch.from_numpy(mask))
            got = port(*args, positions=torch.from_numpy(pos).long(), caches=caches,
                       cross_kvs=kvs)
            plain = port(*args, positions=torch.from_numpy(pos).long(), caches=plain_caches)
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            torch.testing.assert_close(got, plain, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="cross_kvs"):
        port(torch.zeros((B, 1), dtype=torch.long))


# ------------------------------------------------------------ the converter


def test_safetensors_reader_matches_the_package(tmp_path):
    st_np = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    arrays = {
        "f64": rng.normal(size=(3, 2)), "f32": rng.normal(size=(4, 5)).astype(np.float32),
        "f16": rng.normal(size=7).astype(np.float16), "i64": rng.integers(-9, 9, (2, 3)),
        "i32": rng.integers(-9, 9, 5).astype(np.int32), "i16": np.arange(3, dtype=np.int16),
        "i8": np.arange(-3, 3, dtype=np.int8), "u8": np.arange(6, dtype=np.uint8),
        "bool": rng.random(9) > 0.5, "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    st_np.save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = convert_hf.read_safetensors(tmp_path / "a.safetensors")
    want = st_np.load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(want) == set(arrays)
    for k, a in want.items():
        assert got[k].numpy().dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    bf16 = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(1)).bfloat16(),
            "b": torch.arange(4, dtype=torch.bfloat16)}
    st_torch.save_file(bf16, str(tmp_path / "b.safetensors"))
    got = convert_hf.read_safetensors(tmp_path / "b.safetensors")
    for k, t in bf16.items():
        assert got[k].dtype == torch.bfloat16
        torch.testing.assert_close(got[k], t, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_load_state_dict_matches_jax(hf, fmt):
    got = convert_hf.load_state_dict(hf.root / fmt)
    want = jax_convert_cli.load_state_dict(hf.root / fmt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert convert_hf.infer_decoder_layers(got) == jax_convert_cli.infer_decoder_layers(want)
    with pytest.raises(FileNotFoundError):
        convert_hf.load_state_dict(hf.root)


@pytest.mark.parametrize("fmt", ["st", "bin"])
@pytest.mark.parametrize("vocab", [None, 100, 170])
def test_converter_matches_jax(hf, tmp_path, fmt, vocab):
    """``cli.convert_hf`` (the .pt it writes) equals the JAX converter's tree
    after ``convert.py``; ``--vocab-size`` shrinks (100) or grows (170)."""
    argv = ["--checkpoint", str(hf.root / fmt), "--out", str(tmp_path / "bart.pt")]
    if vocab is not None:
        argv += ["--vocab-size", str(vocab)]
    convert_hf.main(argv)
    got = torch.load(tmp_path / "bart.pt", weights_only=True)
    params = jax_convert_hf(jax_convert_cli.load_state_dict(hf.root / fmt),
                            decoder_layers=LAYERS, vocab_size=vocab)
    _, pcfg = _bart_cfgs(vocab=vocab or HF_VOCAB)
    want = convert_variables({"params": params}, BartDecoderModel(pcfg))
    _assert_tensors_equal(got, want, appended=HF_VOCAB if vocab == 170 else None)
    # a state dict of the port's model with the checkpoint's positions
    assert got["embed_positions"].shape == (HF_MAXPOS + 2, D)
    torch.testing.assert_close(got["final_logits_bias"][: min(vocab or HF_VOCAB, HF_VOCAB)],
                               hf.model.final_logits_bias[0, : vocab or HF_VOCAB])
    if vocab == 170:
        assert torch.equal(got["final_logits_bias"][HF_VOCAB:], torch.zeros(30))


def test_converter_edge_cases_match_jax(hf):
    sd = _np_state_dict(hf.model)
    # no final_logits_bias -> zeros; no shared.weight -> the decoder's embedding
    sd = {k: v for k, v in sd.items() if k not in ("final_logits_bias", "model.shared.weight")}
    got = convert_hf_bart_state_dict(sd, decoder_layers=1)
    want = convert_variables({"params": jax_convert_hf(sd, decoder_layers=1)},
                             BartDecoderModel(dataclasses.replace(_bart_cfgs()[1],
                                                                  decoder_layers=1)))
    _assert_tensors_equal(got, want)
    assert not got["final_logits_bias"].any()
    with pytest.raises(KeyError, match="embedding"):
        convert_hf_bart_state_dict({"x": np.zeros(2)}, decoder_layers=1)
    emb = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32))
    assert resize_embedding(emb, 5) is emb and torch.equal(resize_embedding(emb, 2), emb[:2])
    torch.testing.assert_close(resize_embedding(emb, 7)[5:], emb.mean(0).expand(2, 3))


# ------------------------------------------------------------- generation


def _pad_to(arr, length, value):
    out = np.full((arr.shape[0], length), value, arr.dtype)
    out[:, : arr.shape[1]] = arr[:, :length]
    return out


def _hf_generate(model, enc, **kw):
    from transformers.modeling_outputs import BaseModelOutput

    with torch.no_grad():
        return model.generate(
            encoder_outputs=BaseModelOutput(last_hidden_state=torch.from_numpy(enc)),
            attention_mask=torch.ones(enc.shape[:2], dtype=torch.long),
            decoder_start_token_id=START, do_sample=False, **kw).numpy()


@pytest.fixture(scope="module")
def converted(hf):
    """The HF weights in the port's model and in the JAX module."""
    jcfg, pcfg = _bart_cfgs()
    port = BartDecoderModel(pcfg).eval()
    port.load_state_dict(convert_hf_bart_state_dict(hf.model.state_dict(),
                                                    decoder_layers=LAYERS))
    params = jax_convert_hf(_np_state_dict(hf.model), decoder_layers=LAYERS)
    return port, JaxBart(jcfg), {"params": params}


@pytest.mark.parametrize("beams", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bart_generate_matches_jax_and_hf(hf, converted, beams, seed):
    port, jm, variables = converted
    dkw = dict(max_length=12, min_length=3, num_beams=beams, early_stopping=True,
               length_penalty=1.0, pad_token_id=PAD, eos_token_id=EOS,
               decoder_start_token_id=START)
    enc = np.random.default_rng(seed + 10).normal(size=(B, S, D)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[seed % B, seed % S] = 0
    gen = build_bart_generate_fn(port, DecodeParams(**dkw))
    jgen = jax_build_bart_generate_fn(jm, JaxDecodeParams(**dkw), jit=False)
    for m in (None, mask):
        got = gen(torch.from_numpy(enc), None if m is None else torch.from_numpy(m)).numpy()
        want = np.asarray(jgen(variables, jnp.asarray(enc),
                               None if m is None else jnp.asarray(m)))
        np.testing.assert_array_equal(got, want, err_msg=f"mask={m is not None}")
    hf_kw = dict(max_length=12, min_length=3, num_beams=beams)
    if beams > 1:
        hf_kw.update(early_stopping=True, length_penalty=1.0)
    ref = _hf_generate(hf.model, enc, **hf_kw)
    got = gen(torch.from_numpy(enc)).numpy()
    np.testing.assert_array_equal(got, _pad_to(ref, 12, PAD))


def test_bart_generate_hoist_equals_recomputing_cross_attention(converted):
    port, _, _ = converted
    dp = DecodeParams(max_length=10, min_length=2, num_beams=3, pad_token_id=PAD,
                      eos_token_id=EOS, decoder_start_token_id=START)
    enc = torch.from_numpy(np.random.default_rng(7).normal(size=(B, S, D)).astype(np.float32))
    mask = torch.ones((B, S), dtype=torch.int32)
    mask[:, 2] = 0
    got = build_bart_generate_fn(port, dp)(enc, mask)
    for k, search in ((3, beam_search), (1, greedy_search)):
        enc_x, mask_x = enc.repeat_interleave(k, 0), mask.repeat_interleave(k, 0)
        with torch.inference_mode():
            plain = search(
                lambda tok, pos, caches: port(tok, enc_x, mask_x, positions=pos, caches=caches),
                port.init_cache(B * k, dp.max_length), B, dataclasses.replace(dp, num_beams=k))
        hoisted = got if k == 3 else build_bart_generate_fn(
            port, dataclasses.replace(dp, num_beams=1))(enc, mask)
        assert torch.equal(hoisted, plain)


# ----------------------------------------------------------------- the graft


def _port_file(hf, tmp_path):
    convert_hf.main(["--checkpoint", str(hf.root / "st"), "--out", str(tmp_path / "bart.pt")])
    return tmp_path / "bart.pt"


def _jax_dir(hf, tmp_path):
    return jax_convert_cli.main(["--checkpoint", str(hf.root / "bin"),
                                 "--out", str(tmp_path / "jax_bart")])


def _fresh_pair(vocab, maxpos, tie=True, seed=1):
    """A JAX train state whose only tree is ``model.bart`` and a port state
    whose module holds the same weights under ``model.bart``."""
    jcfg, pcfg = _bart_cfgs(vocab=vocab, maxpos=maxpos, tie=tie)
    ids = np.zeros((1, 3), np.int32)
    v = seeded_flax_variables(JaxBart(jcfg), ids, np.zeros((1, S, D), np.float32),
                              np.ones((1, S), np.int32), seed=seed)
    jstate = JaxTrainState(step=0, params={"model": {"bart": v["params"]}}, batch_stats={},
                           opt_state=None, loss_weights={})
    bart = load_flax_variables(BartDecoderModel(pcfg), v)
    return jstate, SimpleNamespace(module=SimpleNamespace(model=SimpleNamespace(bart=bart)))


@pytest.mark.parametrize("vocab", [100, 170])
def test_graft_matches_jax(hf, tmp_path, vocab):
    """Model vocabulary smaller (100) or larger (170) than the checkpoint's
    140, and 32 + 2 positions against its 42: overlap copies."""
    jstate, pstate = _fresh_pair(vocab, 32)
    bart = pstate.module.model.bart
    fresh = {k: v.clone() for k, v in bart.state_dict().items()}
    tensors = dict(bart.named_parameters())
    assert graft_bart_params(pstate, _port_file(hf, tmp_path)) is pstate
    grafted = jax_graft(jstate, _jax_dir(hf, tmp_path))
    want = convert_variables({"params": grafted.params["model"]["bart"]}, bart)
    _assert_tensors_equal(bart.state_dict(), want)
    for k, p in bart.named_parameters():
        assert p is tensors[k]  # in place: the optimizer's tensors
    hf_sd = hf.model.state_dict()
    n = min(vocab, HF_VOCAB)
    torch.testing.assert_close(bart.shared.weight[:n], hf_sd["model.shared.weight"][:n])
    torch.testing.assert_close(bart.shared.weight[n:], fresh["shared.weight"][n:])
    torch.testing.assert_close(bart.embed_positions,
                               hf_sd["model.decoder.embed_positions.weight"][:34])
    torch.testing.assert_close(bart.final_logits_bias[:n], hf_sd["final_logits_bias"][0, :n])


def test_graft_refuses_what_jax_refuses(hf, tmp_path):
    path = _port_file(hf, tmp_path)
    sd = torch.load(path, weights_only=True)
    del sd["layer1.fc2.bias"]
    sd["bogus"] = torch.zeros(1)
    torch.save(sd, tmp_path / "keys.pt")
    _, pstate = _fresh_pair(HF_VOCAB, HF_MAXPOS)
    with pytest.raises(ValueError, match=r"missing=\['layer1.fc2.bias'\] extra=\['bogus'\]"):
        graft_bart_params(pstate, tmp_path / "keys.pt")
    # the untied model has no final_logits_bias: the converted tree has one
    jstate, pstate = _fresh_pair(HF_VOCAB, HF_MAXPOS, tie=False)
    with pytest.raises(ValueError, match=r"missing=\[\] extra=\['final_logits_bias'\]"):
        graft_bart_params(pstate, path)
    with pytest.raises(ValueError, match="final_logits_bias"):
        jax_graft(jstate, _jax_dir(hf, tmp_path))
    sd = torch.load(path, weights_only=True)
    sd["layer0.fc1.weight"] = sd["layer0.fc1.weight"][:, :-1]
    torch.save(sd, tmp_path / "shape.pt")
    _, pstate = _fresh_pair(HF_VOCAB, HF_MAXPOS)
    with pytest.raises(ValueError, match=r"layer0.fc1.weight has shape \(96, 47\)"):
        graft_bart_params(pstate, tmp_path / "shape.pt")


def test_graft_is_stepped_by_the_optimizer(hf, tmp_path):
    """The graft writes into the parameters the optimizer and the train step
    were built over, so a step after it moves the grafted values (no warmup,
    one micro-step)."""
    tok = tiny_tokenizer()
    cfg = _port(tiny_config(tok.vocab_size, n_timepoints=124))
    tc = cfg.training
    cfg = cfg.replace(training=dataclasses.replace(
        tc, grad_accum_steps=1, optimizer=dataclasses.replace(tc.optimizer, warmup_steps=0),
        loss=dataclasses.replace(tc.loss, bow_vocab_size=len(BOW))))
    module = build_train_module(cfg, len(BOW), seed=0, device="cpu")
    optimizer = build_optimizer(dict(module.named_parameters()), cfg.training.optimizer, 10)
    state = create_train_state(module, optimizer,
                               AdaptiveLossScheduler(cfg.training.loss).initial_weights())
    step = make_train_step(module, optimizer, cfg, BOW)
    bart = module.model.bart
    before = dict(bart.named_parameters())
    fresh = {k: v.detach().clone() for k, v in before.items()}
    graft_bart_params(state, _port_file(hf, tmp_path))
    grafted = {k: v.detach().clone() for k, v in bart.named_parameters()}
    assert all(p is before[k] for k, p in bart.named_parameters())
    assert not torch.equal(grafted["layer0.fc1.weight"], fresh["layer0.fc1.weight"])
    batch = {k: torch.from_numpy(v if k == "channel_mask" else v[:1])
             for k, v in _batch(cfg, 0).items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    moved = [k for k, p in bart.named_parameters() if not torch.equal(p, grafted[k])]
    assert "layer0.fc1.weight" in moved and len(moved) > len(grafted) // 2
    for k in moved:  # a step's update away from the grafted value, not the fresh one
        assert (bart.get_parameter(k) - grafted[k]).abs().max() < 1e-2, k


# ------------------------------------------------------ the loss-curve gate


def _cli_args(root, tmp_path, cfg):
    (tmp_path / "vocab.txt").write_text("\n".join(dict.fromkeys(TINY_VOCAB)) + "\n",
                                        encoding="utf-8")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    return ["--data-dir", str(root / "data"), "--montage", str(root / "montage.csv"),
            "--vocab", str(tmp_path / "vocab.txt"), "--config", str(tmp_path / "cfg.json")]


def _losses(path):
    rows = [json.loads(line) for line in path.open()]
    return [(r["_step"], r["train/loss"]) for r in rows if "train/loss" in r]


def test_cli_train_bart_params_matches_jax(hf, corpus, tmp_path, monkeypatch):
    """``cli.train --bart-params`` of both packages for two epochs from the
    same initial weights (seeded into the JAX trainer's tree, converted for
    the port's), dropout off in both,
    grafting the same HF checkpoint (converted by each package's
    ``cli.convert_hf``)."""
    monkeypatch.setenv("WANDB_MODE", "disabled")
    root, jax_cfg, _ = corpus
    args = _cli_args(root, tmp_path, jax_cfg)
    jax_params = _jax_dir(hf, tmp_path)
    port_params = _port_file(hf, tmp_path)
    initial, evals = {}, {"jax": [], "port": []}

    def recording(cls, key):
        evaluate = cls.evaluate

        def record(self, state, *, epoch=0):
            out = evaluate(self, state, epoch=epoch)
            evals[key].append(out)
            return out
        return record

    def seeded_jax_state(module, rng, sample, optimizer, loss_weights):
        """``create_train_state`` with seeded weights: the same tree without
        compiling the model's init (about 15 s of XLA on the CPU)."""
        init = SimpleNamespace(init=functools.partial(module.init, method="init_all"))
        v = seeded_flax_variables(init, sample["eeg"], sample["decoder_input_ids"],
                                  sample["channel_mask"], seed=0)
        initial.update(v)
        params = jax.tree.map(jnp.asarray, v["params"])
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
            opt_state=jax.jit(optimizer.init)(params),
            loss_weights={k: jnp.float32(w) for k, w in loss_weights.items()})

    port_init = EEGTrainer.init_state

    def port_init_from_jax(self, seed=None):
        state = port_init(self, seed)
        load_flax_variables(state.module, initial)
        return state

    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_jax(mp)
        mp.setattr(jax_trainer_module, "create_train_state", seeded_jax_state)
        mp.setattr(JaxTrainer, "evaluate", recording(JaxTrainer, "jax"))
        mp.setattr("imagined_speech_translation_tpu.utils.cache.enable_persistent_cache",
                   lambda *a, **k: None)  # XLA's compile cache would write under $HOME
        jax_train_cli.main(args + ["--out-dir", str(tmp_path / "jax"),
                                   "--bart-params", jax_params])
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_port(mp)
        mp.setattr(EEGTrainer, "init_state", port_init_from_jax)
        mp.setattr(EEGTrainer, "evaluate", recording(EEGTrainer, "port"))
        res = train_cli.main(args + [
            "--device", "cpu", "--out-dir", str(tmp_path / "port"),
            "--bart-params", str(port_params)])
    # the graft landed: the decoder's layers hold the checkpoint's weights
    # (moved by training), not the initial ones
    fc1 = res["state"].module.model.bart.layer0.fc1.weight.detach()
    hf_fc1 = hf.model.state_dict()["model.decoder.layers.0.fc1.weight"]
    init_fc1 = torch.from_numpy(initial["params"]["model"]["bart"]["layer0"]["fc1"]["kernel"].T)
    assert (fc1 - hf_fc1).abs().max() < (fc1 - init_fc1).abs().max()

    want, got = _losses(tmp_path / "jax" / "metrics.jsonl"), _losses(
        tmp_path / "port" / "metrics.jsonl")
    assert [s for s, _ in got] == [s for s, _ in want] and len(got) >= 4
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)
    assert len(evals["port"]) == len(evals["jax"]) >= 3  # 2 epochs + the test split
    for g, w in zip(evals["port"], evals["jax"]):
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-4)
        assert g["predictions"] == w["predictions"]
