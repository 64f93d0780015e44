"""The paper's ablation family (Table 24) in the port against the JAX package.

Each of ``cli.ablation_sweep.VARIANTS``' seven configurations, applied to
``tests.helpers.tiny_config`` through the override paths the sweep passes to
``cli.train``, with weights made from a numpy seed in the variant's own flax
tree and carried across by ``load_flax_variables``:

* the override paths give the JAX package's configuration, and conversion is
  strict: the variant's tree lacks exactly the ablated modules, the port's
  model lacks them too, and the full model's tree does not load into it;
* the whole ``EEGDecodingModel`` forward (logits and fused features) against
  ``imagined_speech_translation_tpu.models`` at ATOL 1e-4, as
  ``tests/test_torch_models.py``;
* the composite loss in eval mode (dropout off, BatchNorm on its running
  statistics) within 1e-4 relative, and its gradients against ``jax.grad``
  within 1e-4 of the largest gradient;
* the region weights the trainer logs, against the JAX encoder's;
* a trainer checkpoint of the variant loads strictly into the served model
  (``cli.serve.load_serving_state_dict``), whose float32 beam ids with
  BatchNorm unfolded equal JAX's ``cli.serve.build_decode_fn`` on the same
  raw windows (token identity is expected only there), and whose
  BatchNorm-folded logits lie within ATOL 1e-4 of the unfolded ones.

Sizes: hidden 48, 2 decoder layers, T = 124 (token sequences of 128 take the
flash route's plain twin), a batch of 2 windows, labels of 6 tokens."""

import dataclasses
import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu import config as jax_config
from imagined_speech_translation_tpu.cli.serve import build_decode_fn as jax_build_decode_fn
from imagined_speech_translation_tpu.data.synthetic import make_synthetic_montage
from imagined_speech_translation_tpu.models import BrainRegionEncoder as JaxBrainEncoder
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.training import AdaptiveLossScheduler as JaxScheduler
from imagined_speech_translation_tpu.training import TrainModule as JaxTrainModule
from imagined_speech_translation_tpu.training import losses as jl
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli.ablation_sweep import VARIANTS, variant_config
from imagined_speech_translation_tpu_torch.cli.serve import (
    build_decode_fn,
    load_serving_state_dict,
)
from imagined_speech_translation_tpu_torch.convert import convert_variables, load_flax_variables
from imagined_speech_translation_tpu_torch.data import RegionSpec
from imagined_speech_translation_tpu_torch.models import build_model, fold_batch_norm
from imagined_speech_translation_tpu_torch.training import (
    CheckpointManager,
    FusedAdamW,
    TrainModule,
    create_train_state,
    make_loss_fn,
)
from tests.helpers import tiny_config
from tests.test_torch_models import few_threads, seeded_flax_variables  # noqa: F401
from tests.test_torch_slice import VOCAB, RecordingTokenizer

T, B, L = 124, 2, 6
ATOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4  # of the largest gradient
BOW = list(range(110, 126))
NAMES = [name for name, *_ in VARIANTS]

# the parameter-path fragments each variant ablates
_CNN_ONLY = ("cnn_to_attn", "cls_token", "temporal_tokens", "pos_emb", "cross_scale_attn",
             "attn0", "ffn0")
_NO_CROSS = ("cross_region_attention", "fusion_layer")
_UNIFORM = ("region_importance", "region_gate_fc")
ABSENT = {
    "full": (),
    "no_cross_region_attn": _NO_CROSS,
    "uniform_region_weight": _UNIFORM,
    "no_pos_emb": ("pos_emb",),
    "cnn_only_region": _CNN_ONLY,
    "no_fusion_transformer": ("fusion_layer",),
    "pure_cnn": _CNN_ONLY + _NO_CROSS + _UNIFORM,
}
FRAGMENTS = sorted({f for fs in ABSENT.values() for f in fs})


def _jax_variant_config(base, name):
    (overrides,) = [ov for n, *_, ov in VARIANTS if n == name]
    for expr in overrides:
        path, _, raw = expr.partition("=")
        base = jax_config.replace_nested(base, path, json.loads(raw))
    return base.validate()


def _flax_paths(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flax_paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def common(tmp_path_factory):
    tok = RecordingTokenizer(VOCAB, eos_token="[EOS]")
    base = tiny_config(tok.vocab_size, n_timepoints=T)
    base = base.replace(training=dataclasses.replace(
        base.training, loss=dataclasses.replace(base.training.loss, bow_vocab_size=len(BOW))))
    labels = make_synthetic_montage(tmp_path_factory.mktemp("montage") / "m.csv")
    spec = RegionSpec.from_channel_names(labels)
    rng = np.random.default_rng(0)
    mask = spec.channel_mask
    eeg = (rng.normal(size=(B, 4, 16, T)) * mask[None, :, :, None]).astype(np.float32)
    vocab = base.model.bart.vocab_size
    ids = rng.integers(105, vocab, (B, L)).astype(np.int32)
    labels_ = np.concatenate([ids[:, 1:], rng.integers(105, vocab, (B, 1))], axis=-1)
    attn = np.ones((B, L), np.int32)
    attn[1, 4:] = 0  # the second sequence is shorter
    labels_[1, 4:] = -100
    batch = dict(eeg=eeg, decoder_input_ids=ids, labels=labels_.astype(np.int32),
                 attention_mask=attn, channel_mask=mask)
    raw = (rng.normal(size=(B, len(labels), T)) * 20.0).astype(np.float32)
    return dict(tok=tok, base=base, spec=spec, batch=batch, raw=raw,
                weights=JaxScheduler(base.training.loss).initial_weights())


@functools.cache
def _variables(cfg):
    """Seeded variables of ``cfg``'s ``TrainModule`` (at the module's batch)."""
    eeg = np.zeros((B, 4, 16, T), np.float32)
    mask = np.ones((4, 16), bool)
    jm = JaxTrainModule(cfg, bow_k=len(BOW))
    init = SimpleNamespace(init=functools.partial(jm.init, method="init_all"))
    return seeded_flax_variables(init, eeg, np.zeros((B, L), np.int32), mask, seed=3)


@pytest.fixture(scope="module", autouse=True)
def no_jax_compile_cache():
    """JAX's ``build_decode_fn`` turns on its persistent compile cache, a
    process-wide setting; the test keeps it off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("imagined_speech_translation_tpu.utils.cache.enable_persistent_cache",
                   lambda *a, **k: None)
        yield


def _jax_outputs(cfg, variables, batch, weights):
    """Eval-mode composite loss, its components, logits and fused features,
    and ``jax.grad`` of the loss, from the JAX package's model and heads."""
    model = JaxModel(cfg.model)
    heads = jl.CompositeLossHeads(hidden_dim=cfg.model.hidden_dim,
                                  bart_dim=cfg.model.bart.d_model, bow_k=len(BOW))

    def loss(params):
        logits, aux = model.apply(
            {"params": params["model"], "batch_stats": variables["batch_stats"]["model"]},
            batch["eeg"], batch["decoder_input_ids"], batch["channel_mask"], return_aux=True)
        total, comps = jl.composite_loss(
            logits=logits, labels=batch["labels"], eeg_feat=aux["features"],
            decoder_hidden=aux["hidden"], decoder_mask=batch["attention_mask"],
            heads_apply=lambda e, t: heads.apply({"params": params["loss_heads"]}, e, t),
            bow_indices=jnp.asarray(BOW), weights=weights, cfg=cfg.training.loss)
        return total, (comps, logits, aux["features"])

    params = jax.tree.map(jnp.asarray, variables["params"])
    (total, (comps, logits, feats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return dict(total=float(total), comps={k: float(v) for k, v in comps.items()},
                logits=np.asarray(logits), feats=np.asarray(feats),
                grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module", params=NAMES)
def variant(request, common, tmp_path_factory):
    name = request.param
    jcfg = _jax_variant_config(common["base"], name)
    pcfg = variant_config(config.Config.from_json(common["base"].to_json()), name)
    variables = _variables(jcfg)
    module = load_flax_variables(TrainModule(pcfg, bow_k=len(BOW)), variables)
    ckpt = tmp_path_factory.mktemp(name)
    state = create_train_state(
        module, FusedAdamW([n for n, _ in module.named_parameters()], pcfg.training.optimizer,
                           10), common["weights"])
    CheckpointManager(ckpt).save_best(state, {"epoch": 0})
    return dict(name=name, jcfg=jcfg, pcfg=pcfg, variables=variables, module=module,
                ckpt=ckpt / "best_model",
                want=_jax_outputs(jcfg, variables, common["batch"], common["weights"]))


def test_override_paths_give_the_jax_configuration(variant):
    assert json.loads(variant["pcfg"].to_json()) == json.loads(variant["jcfg"].to_json())


def test_conversion_is_strict(variant, common):
    name, module = variant["name"], variant["module"]
    flax_paths = list(_flax_paths(variant["variables"]["params"]))
    keys = list(module.state_dict())
    for frag in FRAGMENTS:
        ablated = frag in ABSENT[name]
        assert any(frag in p for p in flax_paths) is not ablated, (name, frag)
        assert any(frag in k for k in keys) is not ablated, (name, frag)
    assert set(convert_variables(variant["variables"], module)) == set(keys)
    if name != "full":
        with pytest.raises(KeyError, match="no port module|no such port tensor"):
            convert_variables(_variables(_jax_variant_config(common["base"], "full")), module)
        with pytest.raises(KeyError, match="without a flax variable"):
            convert_variables(variant["variables"],
                              TrainModule(common["base"], bow_k=len(BOW)))


def test_forward_matches_jax(variant, common):
    b = {k: _t(v) for k, v in common["batch"].items()}
    model = variant["module"].model.eval()
    with torch.no_grad():
        logits = model(b["eeg"], b["decoder_input_ids"].long(), b["channel_mask"])
        feats, _ = model.encode(b["eeg"], b["channel_mask"])
    np.testing.assert_allclose(logits.numpy(), variant["want"]["logits"], atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), variant["want"]["feats"], atol=ATOL)


def test_loss_and_gradients_match_jax(variant, common):
    module, want = variant["module"], variant["want"]
    b = {k: _t(v) for k, v in common["batch"].items()}
    params = dict(module.named_parameters())
    total, comps = make_loss_fn(module, variant["pcfg"], BOW, mixed=False)(
        params, b, None, common["weights"])
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(total.item(), want["total"], rtol=LOSS_RTOL)
    assert set(comps) == set(want["comps"])
    for k, v in want["comps"].items():
        np.testing.assert_allclose(comps[k].item(), v, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    # JAX's gradient tree in the port's layout (the converter's own mapping)
    jgrads = convert_variables({"params": want["grads"],
                                "batch_stats": variant["variables"]["batch_stats"]}, module)
    scale = max(np.abs(g).max() for g in jax.tree.leaves(want["grads"]))
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


def test_region_weights_match_jax(variant):
    cfg = variant["jcfg"].model.brain_encoder
    want = JaxBrainEncoder.region_weights(
        variant["variables"]["params"]["model"]["brain_encoder"], cfg)
    got = variant["module"].model.brain_encoder.region_weights()
    assert got["names"] == want["names"] and got["has_dynamic"] == want["has_dynamic"]
    np.testing.assert_allclose(got["softmax"], want["softmax"], rtol=1e-6)
    assert got["has_dynamic"] is not cfg.uniform_region_weight


def test_served_checkpoint_decodes_as_jax(variant, common):
    tok, spec, raw = common["tok"], common["spec"], common["raw"]
    v = variant["variables"]
    jax_vars = {"params": v["params"]["model"], "batch_stats": v["batch_stats"]["model"]}
    jax_build_decode_fn(variant["jcfg"], tok, spec, jax_vars, fold_bn=False)(raw)
    want = tok.ids
    pcfg = variant["pcfg"]
    model = build_model(pcfg.model, T, seed=0, device="cpu")
    model.load_state_dict(load_serving_state_dict(variant["ckpt"]))  # strict
    build_decode_fn(pcfg, tok, spec, model, device="cpu", fold_bn=False)(raw)
    np.testing.assert_array_equal(tok.ids, want)
    assert (want[:, 1:] != tok.pad_token_id).any()
    b = {k: _t(x) for k, x in common["batch"].items()}
    args = (b["eeg"], b["decoder_input_ids"].long(), b["channel_mask"])
    with torch.no_grad():
        folded = fold_batch_norm(model)(*args)
        unfolded = model(*args)
    np.testing.assert_allclose(folded.numpy(), unfolded.numpy(), atol=ATOL)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_ring_attention_needs_the_token_path(package):
    mod = jax_config if package == "jax" else config
    cfg = mod.default_config()
    cfg = mod.replace_nested(cfg, "model.brain_encoder.region_encoder.cnn_only", True)
    cfg = mod.replace_nested(cfg, "model.brain_encoder.region_encoder.seq_shards", 2)
    with pytest.raises(ValueError, match="seq_shards>1 needs the token-attention path"):
        cfg.validate()
