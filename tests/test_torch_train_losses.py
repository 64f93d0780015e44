"""The port's composite loss, adaptive scheduler, BoW vocabulary pick,
learning-rate schedules and fused AdamW against the JAX package's, on the
same inputs made with numpy.

Tolerances: losses in float32 within 1e-6 relative (a few reductions in
another order); schedules within 1e-6 relative (both evaluate optax's
formulas in float32, but numpy's and XLA's cosines may differ by one ulp,
which ``1 + cos`` near the end of the decay amplifies); one fused AdamW
update within 1e-6 relative on parameters and moments (2e-2 on a bfloat16
``mu``, one bfloat16 rounding); the scheduler, the vocabulary pick and the
group labels exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.config import LossConfig as JaxLossConfig
from imagined_speech_translation_tpu.config import OptimizerConfig as JaxOptimizerConfig
from imagined_speech_translation_tpu.training import losses as jl
from imagined_speech_translation_tpu.training import optimizer as jopt
from imagined_speech_translation_tpu.training.train_state import TrainModule as JaxTrainModule
from imagined_speech_translation_tpu.utils.trees import (
    label_params_by_substring as jax_labels,
)
from imagined_speech_translation_tpu.utils.trees import tree_flatten_with_names
from imagined_speech_translation_tpu_torch.config import LossConfig, OptimizerConfig
from imagined_speech_translation_tpu_torch.convert import convert_variables
from imagined_speech_translation_tpu_torch.training import TrainModule, losses, optimizer
from tests.helpers import tiny_config, tiny_tokenizer
from tests.test_torch_models import few_threads  # noqa: F401

RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    B, L, V, H = 4, 7, 60, 24
    labels = rng.integers(0, V, (B, L))
    labels[1, 5:] = -100
    labels[3, 2:] = -100
    mask = (labels != -100).astype(np.int32)
    return dict(
        logits=rng.normal(size=(B, L, V)).astype(np.float32) * 3,
        labels=labels.astype(np.int32), mask=mask,
        eeg_feat=rng.normal(size=(B, H)).astype(np.float32),
        hidden=rng.normal(size=(B, L, H)).astype(np.float32),
        bow=np.asarray([0, 3, 5, 7, 11, 13, 40, 59]),
        w_eeg=rng.normal(size=(H, 16)).astype(np.float32) * 0.2,
        w_txt=rng.normal(size=(H, 16)).astype(np.float32) * 0.2,
        w_bow=rng.normal(size=(H, 8)).astype(np.float32) * 0.2,
        b=rng.normal(size=(3, 16)).astype(np.float32) * 0.1,
    )


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_label_smoothed_ce_matches_jax(data, smoothing):
    want, n = jl.label_smoothed_ce(data["logits"], data["labels"], label_smoothing=smoothing)
    got, m = losses.label_smoothed_ce(_t(data["logits"]), _t(data["labels"]),
                                      label_smoothing=smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    assert int(m) == int(n)


@pytest.mark.parametrize("name", ["info_nce", "bow_multi_hot", "diversity", "variance", "bce"])
def test_loss_components_match_jax(data, name):
    e, h = data["eeg_feat"], data["hidden"][:, 0]
    calls = {
        "info_nce": lambda m, x: m._info_nce(x(e), x(h), 0.07),
        "bow_multi_hot": lambda m, x: m._bow_multi_hot(x(data["labels"]), x(data["bow"]), 60),
        "diversity": lambda m, x: m._diversity_loss(x(e)),
        "variance": lambda m, x: m._variance_loss(x(e)),
        "bce": lambda m, x: m.optax_sigmoid_bce(x(e[:, :8]), x((e[:, 8:16] > 0) * 1.0)),
    }
    want = np.asarray(calls[name](jl, jnp.asarray))
    got = calls[name](losses, _t).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_composite_loss_matches_jax(data):
    cfg_j, cfg_t = JaxLossConfig(bow_vocab_size=8), LossConfig(bow_vocab_size=8)
    weights = {"ce": 1.0, "align": 0.5, "bow": 0.15, "div": 0.1, "var": 0.05}
    heads = jl.CompositeLossHeads(hidden_dim=24, bart_dim=24, bow_k=8, proj_dim=16)
    params = {"params": {
        "eeg_proj": {"kernel": data["w_eeg"], "bias": data["b"][0]},
        "txt_proj": {"kernel": data["w_txt"], "bias": data["b"][1]},
        "bow_head": {"kernel": data["w_bow"], "bias": data["b"][2, :8]},
    }}
    theads = losses.CompositeLossHeads(24, 24, 8, proj_dim=16)
    with torch.no_grad():
        for name in ("eeg_proj", "txt_proj", "bow_head"):
            layer = getattr(theads, name)
            layer.weight.copy_(_t(params["params"][name]["kernel"]).T)
            layer.bias.copy_(_t(params["params"][name]["bias"]))
    kw = dict(weights=weights)
    want, wcomps = jl.composite_loss(
        logits=data["logits"], labels=data["labels"], eeg_feat=data["eeg_feat"],
        decoder_hidden=data["hidden"], decoder_mask=data["mask"],
        heads_apply=lambda a, b: heads.apply(params, a, b), bow_indices=data["bow"],
        cfg=cfg_j, **kw)
    got, gcomps = losses.composite_loss(
        logits=_t(data["logits"]), labels=_t(data["labels"]), eeg_feat=_t(data["eeg_feat"]),
        decoder_hidden=_t(data["hidden"]), decoder_mask=_t(data["mask"]),
        heads_apply=theads, bow_indices=_t(data["bow"]), cfg=cfg_t, **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for k in wcomps:
        np.testing.assert_allclose(gcomps[k].item(), float(wcomps[k]), rtol=RTOL, err_msg=k)


def test_adaptive_scheduler_trajectory_matches_jax():
    ours, theirs = losses.AdaptiveLossScheduler(LossConfig()), jl.AdaptiveLossScheduler(
        JaxLossConfig())
    rng = np.random.default_rng(1)
    for i in range(40):
        diversity = [0.1, 0.5, 0.9][i // 8 % 3] + rng.normal() * 0.05
        comps = {f"loss_{k}": float(rng.uniform(0.5, 1.5) + (i % 5) * 0.01)
                 for k in ("ce", "align", "bow", "div", "var")}
        assert ours.update(comps, diversity) == theirs.update(comps, diversity)
    assert ours.state_dict() == theirs.state_dict()


@pytest.mark.parametrize("texts", [None, ["我想喝水", "请帮我打开窗户", "我想休息一下"]])
def test_top_k_vocab_indices_match_jax(texts):
    tok = tiny_tokenizer()
    assert losses.get_top_k_vocab_indices(tok, 12, texts) == jl.get_top_k_vocab_indices(
        tok, 12, texts)


@pytest.mark.parametrize("schedule, warmup, total", [
    ("cosine", 500, 3), ("cosine", 4, 20), ("cosine", 0, 10), ("linear", 3, 12),
    ("linear", 0, 5),
])
def test_schedule_matches_optax(schedule, warmup, total):
    kw = dict(schedule=schedule, warmup_steps=warmup)
    want = jopt.make_schedule(3e-4, JaxOptimizerConfig(**kw), total)
    got = optimizer.make_schedule(3e-4, OptimizerConfig(**kw), total)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {step}")


@pytest.fixture(scope="module")
def named_tree():
    """The tiny TrainModule's parameter tree: flax names and shapes."""
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=64)
    jm = JaxTrainModule(cfg, bow_k=16)
    rng = np.random.default_rng(2)
    eeg = np.zeros((2, 4, 16, 64), np.float32)
    ids = np.zeros((2, 5), np.int32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), eeg, ids, None,
                                            method="init_all"))
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    return cfg, variables


def test_param_groups_match_jax(named_tree):
    cfg, variables = named_tree
    labels = jax_labels(variables["params"], jopt.GROUP_RULES, default="projection")
    want = {}
    for (_, label), (_, leaf) in zip(tree_flatten_with_names(labels),
                                     tree_flatten_with_names(variables["params"])):
        want[label] = want.get(label, 0) + leaf.size
    module = TrainModule(cfg, bow_k=16)
    state = convert_variables(variables, module)
    names = [n for n, _ in module.named_parameters()]
    ours = optimizer.label_params_by_substring(names, optimizer.GROUP_RULES, "projection")
    got = {}
    for name, label in ours.items():
        got[label] = got.get(label, 0) + state[name].numel()
    assert got == want and set(got) == {"encoder", "projection", "bart"}


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_fused_adamw_update_matches_jax(mu_dtype):
    rng = np.random.default_rng(3)
    names = ["model/brain_encoder/w", "model/eeg_to_bart_fc/kernel", "model/bart/x",
             "loss_heads/eeg_proj/kernel"]
    shapes = [(6, 5), (7,), (3, 4), (5, 2)]
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in zip(names, shapes)}
    kw = dict(warmup_steps=2, mu_dtype=mu_dtype, max_grad_norm=1.0)
    jcfg, tcfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    jtree = {n: jnp.asarray(p) for n, p in params.items()}
    jopt_ = jopt.build_optimizer(jtree, dataclasses.replace(jcfg, fused=True), 10)
    jstate = jopt_.init(jtree)
    topt = optimizer.FusedAdamW(names, tcfg, 10)
    tparams = {n: _t(p).clone() for n, p in params.items()}
    tstate = topt.init(tparams)
    for step in range(3):  # lr 0, then two warmup/cosine steps; clipped on the last
        grads = {n: rng.normal(size=s).astype(np.float32) * (0.1 if step < 2 else 3.0)
                 for n, s in zip(names, shapes)}
        upd, jstate = jopt_.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                                   jtree)
        jtree = jax.tree.map(lambda p, u: p + u, jtree, upd)
        norm = topt.update(tparams, {n: _t(g) for n, g in grads.items()}, tstate)
        np.testing.assert_allclose(norm.item(), float(jopt.optax.global_norm(grads)),
                                   rtol=RTOL)
        for n in names:
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(jtree[n]), rtol=RTOL,
                                       atol=1e-8, err_msg=n)
            np.testing.assert_allclose(tstate.nu[n].numpy(), np.asarray(jstate.nu[n]),
                                       rtol=RTOL, atol=1e-10, err_msg=n)
            mu = tstate.mu[n]
            assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
            np.testing.assert_allclose(mu.float().numpy(),
                                       np.asarray(jstate.mu[n], np.float32),
                                       rtol=2e-2 if mu_dtype else RTOL, atol=1e-8,
                                       err_msg=n)
    assert tstate.count == int(jstate.count) == 3
