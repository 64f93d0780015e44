"""Port model modules vs the JAX package on the same (converted) weights:
region encoder (BatchNorm, GroupNorm, cnn-only), brain encoder, the model's
encode and teacher-forced forward, the KV-cache decode step, BatchNorm
folding, the converter's strictness and the seeded init.

Sizes: the tiny test config (hidden 48, 2 decoder layers) at T = 124, so the
region encoders' token sequences (T + 4 = 128) take the flash route.
Tolerance: atol 1e-4 on float32 outputs of magnitude ~1-4 (a few hundred
float32 ops deep, summed in different orders)."""

import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.models import BrainRegionEncoder as JaxBrainEncoder
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.models import RegionConvAttentionEncoder as JaxRegionEncoder
from imagined_speech_translation_tpu_torch.convert import convert_variables, load_flax_variables
from imagined_speech_translation_tpu_torch.models import (
    EEGDecodingModel,
    RegionConvAttentionEncoder,
    build_model,
    fold_batch_norm,
)
from tests.helpers import tiny_config, tiny_tokenizer

T = 124
ATOL = 1e-4


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for a module of tiny shapes (the port's test
    modules import it): more gain nothing at these sizes, and under six
    pytest-xdist workers a thread a core each oversubscribes the CPU, which
    slows every worker several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)



def seeded_flax_variables(module, *init_args, seed):
    """Variables with the tree and shapes of ``module.init(*init_args)``,
    filled from a numpy seed.  The tree is traced, not compiled: compiling a
    tiny model's random init costs XLA about ten seconds on the CPU.  Kernels
    and embeddings ~ N(0, 1/fan_in); norm scales ~ 1 + N(0, 0.3^2) and every
    other leaf (biases, BatchNorm means) ~ N(0, 0.3^2), so each affine and
    BatchNorm term counts; BatchNorm variances lie in [0.3, ~3)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *init_args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("kernel", "embedding"):
            a = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = np.abs(rng.normal(size=leaf.shape)) + 0.3
        else:
            a = (name == "scale") + rng.normal(size=leaf.shape) * 0.3
        return a.astype(leaf.dtype)

    return _numpy_tree(jax.tree_util.tree_map_with_path(fill, shapes))


@pytest.fixture(scope="module")
def setup():
    tok = tiny_tokenizer()
    cfg = tiny_config(tok.vocab_size, n_timepoints=T)
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    eeg = (rng.normal(size=(2, 4, 16, T)) * mask[None, :, :, None]).astype(np.float32)
    ids = rng.integers(0, tok.vocab_size, (2, 6)).astype(np.int32)
    jm = JaxModel(cfg.model)
    variables = seeded_flax_variables(jm, eeg, ids, mask, seed=1)
    tm = load_flax_variables(EEGDecodingModel(cfg.model, T).eval(), variables)
    return dict(cfg=cfg, jm=jm, tm=tm, variables=variables, eeg=eeg, ids=ids, mask=mask)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("variant", ["batch", "group", "cnn_only"])
def test_region_encoder_matches_jax(setup, variant):
    rcfg = setup["cfg"].model.brain_encoder.region_encoder
    if variant == "group":
        rcfg = dataclasses.replace(rcfg, norm="group", groupnorm_groups=4)
    elif variant == "cnn_only":
        rcfg = dataclasses.replace(rcfg, cnn_only=True)
    x = np.random.default_rng(2).normal(size=(2, T, 6)).astype(np.float32)  # (B, T, C)
    jenc = JaxRegionEncoder(rcfg, hidden_dim=48)
    variables = seeded_flax_variables(jenc, x, seed=4)
    want = np.asarray(jax.jit(jenc.apply)(variables, x))
    # one region: the vmap-stacked layout with R = 1
    stacked = jax.tree.map(lambda a: a[None], variables)
    tenc = RegionConvAttentionEncoder(rcfg, 48, n_regions=1, in_channels=6, n_timepoints=T)
    load_flax_variables(tenc.eval(), stacked)
    with torch.no_grad():
        got = tenc(_t(x).transpose(1, 2)[:, None])  # (B, 1, C, T) -> (1, B, h)
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL)


def test_brain_encoder_matches_jax(setup):
    v = setup["variables"]
    sub = {c: v[c]["brain_encoder"] for c in ("params", "batch_stats")}
    want = jax.jit(JaxBrainEncoder(setup["cfg"].model.brain_encoder).apply)(
        sub, setup["eeg"], setup["mask"]
    )
    with torch.no_grad():
        got = setup["tm"].brain_encoder(_t(setup["eeg"]), _t(setup["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _remat(encoder, on: bool):
    enc = copy.deepcopy(encoder)
    enc.cfg = dataclasses.replace(enc.cfg, remat=on)
    return enc


@pytest.mark.parametrize("dropout", [True, False], ids=["dropout", "no-dropout"])
def test_remat_gradients_match_without_remat(setup, dropout):
    # train mode: dropout (attention 0.1, the encoders' own tiers) from the
    # generator, or none; BatchNorm on batch statistics either way
    eeg = _t(setup["eeg"])
    runs = {}
    for on in (False, True):
        enc = _remat(setup["tm"].brain_encoder, on).train()
        calls = []
        enc.region_encoders.register_forward_pre_hook(lambda *_: calls.append(1))
        gen = torch.Generator().manual_seed(11) if dropout else None
        out = enc(eeg, _t(setup["mask"]), gen)
        params = [p for n, p in enc.named_parameters() if n.startswith("region_encoders.")]
        grads = torch.autograd.grad(out.square().sum(), params)
        runs[on] = dict(out=out.detach(), grads=grads, calls=len(calls),
                        gen=None if gen is None else gen.get_state(),
                        stats=[b.clone() for b in enc.buffers()])
    off, on = runs[False], runs[True]
    assert (off["calls"], on["calls"]) == (1, 2)  # remat recomputes in the backward
    torch.testing.assert_close(on["out"], off["out"], rtol=1e-6, atol=0)
    for a, b in zip(on["grads"], off["grads"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    if dropout:  # the generator stands where it would without remat
        assert torch.equal(on["gen"], off["gen"])
    # the recompute leaves the running statistics as the first run left them
    assert len(off["stats"]) > 0
    for a, b in zip(on["stats"], off["stats"]):
        assert torch.equal(a, b)


def test_remat_brain_encoder_matches_jax(setup):
    # eval mode; the port's remat runs where autograd records, so the input
    # takes gradients, and they are held to jax.grad through nn.remat too
    cfg = dataclasses.replace(setup["cfg"].model.brain_encoder, remat=True)
    v = setup["variables"]
    sub = {c: v[c]["brain_encoder"] for c in ("params", "batch_stats")}
    jenc = JaxBrainEncoder(cfg)

    def loss(e):
        out = jenc.apply(sub, e, setup["mask"])
        return (out * out).sum(), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(setup["eeg"])
    enc = _remat(setup["tm"].brain_encoder, True).eval()
    eeg = _t(setup["eeg"]).requires_grad_()
    got = enc(eeg, _t(setup["mask"]))
    (got_grad,) = torch.autograd.grad(got.square().sum(), eeg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    scale = np.abs(np.asarray(want_grad)).max()
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), atol=1e-5 * scale)


def test_encode_and_forward_match_jax(setup):
    jm, v, eeg, mask, ids = (setup[k] for k in ("jm", "variables", "eeg", "mask", "ids"))
    feat, enc = jax.jit(functools.partial(jm.apply, method="encode"))(v, eeg, mask)
    logits = jax.jit(jm.apply)(v, eeg, ids, mask)
    with torch.no_grad():
        tfeat, tenc = setup["tm"].encode(_t(eeg), _t(mask))
        tlogits = setup["tm"](_t(eeg), _t(ids).long(), _t(mask))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(feat), atol=ATOL)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), atol=ATOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=ATOL)


def test_kv_cache_decode_steps_match_jax(setup):
    jm, tm, v = setup["jm"], setup["tm"], setup["variables"]
    b, L = 2, 5
    enc = np.random.default_rng(5).normal(size=(b, 3, 48)).astype(np.float32)
    enc = np.repeat(enc[:, :1], 3, axis=1)  # the tiled pseudo-encoder
    jconsts = jm.apply(v, enc, method="cross_consts")
    jcaches = jm.init_cache(b, L)
    tcaches = tm.init_cache(b, L)
    ids = setup["ids"]
    with torch.no_grad():
        tconsts = tm.cross_consts(_t(enc))
        for pos in range(L):
            tok = ids[:, pos : pos + 1]
            p = np.full((b, 1), pos, np.int32)
            jl, jcaches = jm.apply(v, tok, p, jconsts, jcaches, method="decode_step_const")
            tl = tm.decode_step_const(_t(tok).long(), _t(p).long(), tconsts, tcaches)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tcaches[0]["index"] == L


def test_fold_batch_norm_preserves_encode(setup):
    tm, eeg, mask = setup["tm"], _t(setup["eeg"]), _t(setup["mask"])
    folded = fold_batch_norm(tm)
    with torch.no_grad():
        want = tm.encode(eeg, mask)[0]
        got = folded.encode(eeg, mask)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    enc = folded.brain_encoder.region_encoders
    for bn in (enc.stage0_convbn.bn, enc.stage0_residual.bn, enc.stage2_bn):
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
        torch.testing.assert_close(bn.running_var, torch.full_like(bn.running_var, 1 - 1e-5))
    # conv + bias absorbs the shift; the bias-less residual keeps it in the BN
    assert torch.equal(enc.stage0_convbn.bn.bias, torch.zeros_like(enc.stage0_convbn.bn.bias))
    assert enc.stage0_residual.bn.bias.abs().max() > 0
    # the caller's model is untouched
    assert not torch.equal(tm.brain_encoder.region_encoders.stage0_convbn.bn.weight,
                           enc.stage0_convbn.bn.weight)


def test_convert_is_strict(setup):
    tm, v = setup["tm"], setup["variables"]
    extra = _numpy_tree(v)
    extra["params"]["bart"]["unused"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no port module"):
        convert_variables(extra, tm)
    extra = _numpy_tree(v)
    extra["params"]["bart"]["layer0"]["fc1"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no such port tensor"):
        convert_variables(extra, tm)
    missing = _numpy_tree(v)
    del missing["params"]["bart"]["final_logits_bias"]
    with pytest.raises(KeyError, match="bart.final_logits_bias"):
        convert_variables(missing, tm)
    wrong = _numpy_tree(v)
    wrong["params"]["eeg_to_bart_fc"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="eeg_to_bart_fc.bias"):
        convert_variables(wrong, tm)


def test_build_model_is_seeded(setup):
    cfg = setup["cfg"].model
    a, b, c = (build_model(cfg, T, seed=s, device="cpu") for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert sa.keys() == setup["tm"].state_dict().keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["bart.shared.weight"], sc["bart.shared.weight"])
    assert all(torch.isfinite(t).all() for t in sa.values())
    assert not a.training
    with torch.no_grad():
        feat, _ = a.encode(_t(setup["eeg"]), _t(setup["mask"]))
    assert feat.shape == (2, 48) and torch.isfinite(feat).all()
