"""The port's whole train step against the JAX package's ``make_train_step``
on the same converted weights and batches: the loss components, the grad
norm, the parameters after each optimizer step and the BatchNorm running
statistics; the eval step's losses; the determinism of the dropout stream,
and that train mode differs from eval mode; the converter's strictness on
the ``TrainModule`` tree.

Sizes: ``tests.helpers.tiny_config`` (hidden 48, 2 decoder layers) at
T = 124 (token sequences of 128 take the flash route), micro-batch 2,
accumulation 2, label length 6.

Dropout bits cannot agree between flax's ``nn.Dropout`` and torch, so the
parity cases neutralise dropout in the test only: ``flax.linen.Dropout``
becomes the identity and the rate reaching ``dot_product_attention`` in the
JAX package's ``models.layers`` is zeroed; the port's ``dropout`` and
``dot_product_attention`` are patched the same way in its model modules.

Tolerances (float32): loss components and grad norm within 1e-4 relative;
BatchNorm statistics within 1e-4; parameters within 1e-6 plus 1e-3 of the
step's largest learning rate, except for at most 0.1% of the entries, which
stay within 2.1 learning rates.  Adam's first steps move each weight by
about +-lr whatever the gradient's size, so an entry whose gradient is
rounding noise (the key-projection biases, whose exact gradient is zero
since softmax ignores a per-row constant) moves by noise-driven amounts of
up to 2 lr in either framework; about 0.025% of the entries do.  Mixed
precision (bfloat16 forward and carry) rounds at other points in the two
frameworks: loss within 2e-2 relative, grad norm within 5e-2.
"""

import dataclasses
import functools
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imagined_speech_translation_tpu.models.layers as jax_layers
from imagined_speech_translation_tpu.training import AdaptiveLossScheduler as JaxScheduler
from imagined_speech_translation_tpu.training import TrainModule as JaxTrainModule
from imagined_speech_translation_tpu.training import TrainState as JaxTrainState
from imagined_speech_translation_tpu.training import build_optimizer as jax_build_optimizer
from imagined_speech_translation_tpu.training import make_eval_step as jax_make_eval_step
from imagined_speech_translation_tpu.training import make_train_step as jax_make_train_step
from imagined_speech_translation_tpu_torch.convert import convert_variables, load_flax_variables
from imagined_speech_translation_tpu_torch.models import bart, brain_encoder, layers
from imagined_speech_translation_tpu_torch.training import (
    FusedAdamW,
    TrainModule,
    create_train_state,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
from tests.helpers import tiny_config, tiny_tokenizer
from tests.test_torch_models import seeded_flax_variables

T, B, ACCUM, L = 124, 2, 2, 6
BOW = list(range(110, 126))
TOTAL_STEPS = 10


def _batch(cfg, seed):
    """A window batch ``(accum, B, ...)`` made with numpy."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    eeg = rng.normal(size=(ACCUM, B, 4, 16, T)) * mask[None, None, :, :, None]
    vocab = cfg.model.bart.vocab_size
    ids = rng.integers(105, vocab, (ACCUM, B, L))
    labels = np.concatenate([ids[..., 1:], rng.integers(105, vocab, (ACCUM, B, 1))], axis=-1)
    attn = np.ones((ACCUM, B, L), np.int32)
    attn[:, 1, 4:] = 0  # the second sequence is shorter
    labels[:, 1, 4:] = -100
    return dict(eeg=eeg.astype(np.float32), decoder_input_ids=ids.astype(np.int32),
                labels=labels.astype(np.int32), attention_mask=attn, channel_mask=mask)


def _no_dropout_jax(mp):
    mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    attention = jax_layers.dot_product_attention
    mp.setattr(jax_layers, "dot_product_attention",
               lambda *a, **k: attention(*a, **dict(k, dropout_rate=0.0)))


def _no_dropout_port(mp):
    for mod in (layers, brain_encoder, bart):
        mp.setattr(mod, "dropout", lambda x, rate, generator, **kw: x)
    attention = layers.dot_product_attention
    mp.setattr(layers, "dot_product_attention",
               lambda *a, **k: attention(*a, **dict(k, dropout_rate=0.0)))


@pytest.fixture(scope="module")
def setup():
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=T)
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=B, grad_accum_steps=ACCUM,
        loss=dataclasses.replace(cfg.training.loss, bow_vocab_size=len(BOW)),
    ))
    jm = JaxTrainModule(cfg, bow_k=len(BOW))
    b0 = _batch(cfg, 0)
    init = SimpleNamespace(init=functools.partial(jm.init, method="init_all"))
    variables = seeded_flax_variables(
        init, b0["eeg"][0], b0["decoder_input_ids"][0], b0["channel_mask"], seed=3
    )
    weights = JaxScheduler(cfg.training.loss).initial_weights()
    return dict(cfg=cfg, jm=jm, variables=variables, weights=weights,
                batches=[_batch(cfg, 1), _batch(cfg, 2)])


def _jax_run(setup, cfg, n_steps):
    jm, v = setup["jm"], setup["variables"]
    params = jax.tree.map(jnp.asarray, v["params"])
    opt = jax_build_optimizer(params, cfg.training.optimizer, TOTAL_STEPS)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=opt.init(params),
        loss_weights={k: jnp.float32(w) for k, w in setup["weights"].items()},
    )
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_jax(mp)
        step = jax.jit(jax_make_train_step(jm, opt, cfg, BOW))
        out = []
        for i in range(n_steps):
            batch = {k: jnp.asarray(a) for k, a in setup["batches"][i].items()}
            state, metrics = step(state, batch, jax.random.key(i))
            out.append({k: float(m) for k, m in metrics.items()})
    return state, out


def _port_run(setup, cfg, n_steps):
    module = load_flax_variables(TrainModule(cfg, bow_k=len(BOW)), setup["variables"])
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     TOTAL_STEPS)
    state = create_train_state(module, opt, setup["weights"])
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_port(mp)
        step = make_train_step(module, opt, cfg, BOW)
        out = []
        for i in range(n_steps):
            batch = {k: torch.from_numpy(a) for k, a in setup["batches"][i].items()}
            state, metrics = step(state, batch, torch.Generator().manual_seed(i))
            out.append({k: float(m) for k, m in metrics.items()})
    return state, out


@pytest.fixture(scope="module")
def f32_runs(setup):
    cfg = setup["cfg"]
    return _jax_run(setup, cfg, 2), _port_run(setup, cfg, 2)


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_metrics_match_jax(f32_runs, step):
    (_, jax_metrics), (_, port_metrics) = f32_runs
    want, got = jax_metrics[step], port_metrics[step]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_train_step_params_and_batch_stats_match_jax(setup, f32_runs):
    (jax_state, _), (port_state, _) = f32_runs
    want = convert_variables(
        {"params": jax.tree.map(np.asarray, jax_state.params),
         "batch_stats": jax.tree.map(np.asarray, jax_state.batch_stats)},
        port_state.module,
    )
    got = port_state.module.state_dict()
    lr_max = 0.5 * setup["cfg"].training.optimizer.encoder_lr  # step 1 of 2 warmup steps
    flipped = 0
    for key, w in want.items():
        g = got[key]
        if "running_" in key:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
            continue
        diff = (g - w).abs()
        assert diff.max() <= 1e-6 + 1e-3 * lr_max + lr_max * 2.1, key
        flipped += int((diff > 1e-6 + 1e-3 * lr_max).sum())
    n = sum(t.numel() for k, t in want.items() if "running_" not in k)
    assert flipped <= 1e-3 * n, f"{flipped} of {n} parameters moved differently"


def test_optimizer_state_matches_jax(f32_runs):
    (jax_state, _), (port_state, _) = f32_runs
    assert port_state.step == int(jax_state.step) == 2
    assert port_state.opt_state.count == int(jax_state.opt_state.count)
    mu = convert_variables({
        "params": jax.tree.map(lambda a: np.asarray(a, np.float32), jax_state.opt_state.mu),
        "batch_stats": jax.tree.map(np.asarray, jax_state.batch_stats),
    }, port_state.module)
    for key, w in mu.items():
        if "running_" in key:
            continue
        g = port_state.opt_state.mu[key]
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2, atol=1e-7,
                                   err_msg=key)


def test_mixed_precision_train_step_close_to_jax(setup):
    cfg = setup["cfg"]
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, mixed_precision=True, grad_accum_dtype="bfloat16"))
    (_, want), (state, got) = _jax_run(setup, cfg, 1), _port_run(setup, cfg, 1)
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=2e-2)
    np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"], rtol=5e-2)
    assert all(p.dtype == torch.float32 for p in state.module.parameters())


def test_eval_step_matches_jax(setup):
    cfg, v = setup["cfg"], setup["variables"]
    micro = {k: a if k == "channel_mask" else a[0] for k, a in setup["batches"][0].items()}
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]), opt_state=None,
        loss_weights={k: jnp.float32(w) for k, w in setup["weights"].items()},
    )
    want = jax.jit(jax_make_eval_step(setup["jm"], cfg, BOW))(
        jstate, {k: jnp.asarray(a) for k, a in micro.items()})
    module = load_flax_variables(TrainModule(cfg, bow_k=len(BOW)), v)
    state = create_train_state(
        module, FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                           TOTAL_STEPS), setup["weights"])
    eval_step = make_eval_step(module, cfg, BOW)
    batch = {k: torch.from_numpy(a) for k, a in micro.items()}
    got, again = eval_step(state, batch), eval_step(state, batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
        assert torch.equal(got[k], again[k])


def test_train_mode_dropout_is_seeded_and_differs_from_eval(setup):
    """With dropout on (no patches): the same generator seed gives the same
    train-mode loss, another seed another loss, and eval mode a third."""
    cfg = setup["cfg"]
    module = load_flax_variables(TrainModule(cfg, bow_k=len(BOW)), setup["variables"])
    params = dict(module.named_parameters())
    loss_fn = make_loss_fn(module, cfg, BOW)
    micro = {k: torch.from_numpy(a if k == "channel_mask" else a[0])
             for k, a in setup["batches"][0].items()}
    with torch.no_grad():
        def loss(generator):
            return loss_fn(params, micro, generator, setup["weights"])[0].item()

        first, again = (loss(torch.Generator().manual_seed(5)) for _ in range(2))
        other, evaluated = loss(torch.Generator().manual_seed(6)), loss(None)
    assert first == again
    assert len({first, other, evaluated}) == 3
    with pytest.raises(ValueError, match="dropout generator"):
        module.train()(*(micro[k] for k in ("eeg", "decoder_input_ids", "channel_mask")))


def test_convert_train_module_is_strict(setup):
    module = TrainModule(setup["cfg"], bow_k=len(BOW))
    v = setup["variables"]
    extra = {"params": dict(v["params"], loss_heads=dict(v["params"]["loss_heads"],
                                                          extra_head={"bias": np.zeros(3)})),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="no port module"):
        convert_variables(extra, module)
    with pytest.raises(KeyError, match="without a flax variable"):
        convert_variables({"params": v["params"]}, module)
    assert set(convert_variables(v, module)) == set(module.state_dict())


def test_train_step_without_composite_loss_gives_unused_heads_zero_gradients(setup):
    """The loss heads take no part in the plain CE loss; as under jax.grad
    they get zero gradients, so only weight decay moves them."""
    cfg = setup["cfg"]
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, loss=dataclasses.replace(cfg.training.loss, composite=False),
        optimizer=dataclasses.replace(cfg.training.optimizer, warmup_steps=0)))
    module = load_flax_variables(TrainModule(cfg, bow_k=len(BOW)), setup["variables"])
    opt = FusedAdamW([n for n, _ in module.named_parameters()], cfg.training.optimizer,
                     TOTAL_STEPS)
    state = create_train_state(module, opt, setup["weights"])
    head = module.loss_heads.eeg_proj.weight.detach().clone()
    batch = {k: torch.from_numpy(a) for k, a in setup["batches"][0].items()}
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout_port(mp)
        state, metrics = make_train_step(module, opt, cfg, BOW)(
            state, batch, torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss_ce", "loss", "grad_norm"}
    assert torch.equal(metrics["loss"], metrics["loss_ce"])
    assert torch.equal(state.opt_state.nu["loss_heads.eeg_proj.weight"],
                       torch.zeros_like(head))
    lr = cfg.training.optimizer.projection_lr
    torch.testing.assert_close(module.loss_heads.eeg_proj.weight.detach(),
                               head - lr * cfg.training.optimizer.weight_decay * head)
