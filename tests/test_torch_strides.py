"""Strided and even-kernel conv stems: the port's ``RegionConv`` and
``RegionConvAttentionEncoder`` against flax ``padding='SAME'`` and the JAX
module on the same (converted) weights.

flax ``SAME`` gives ``ceil(T / s)`` outputs and pads ``total // 2`` on the
left and the rest on the right, ``total = max((ceil(T/s) - 1) * s + k - T,
0)``; a stride other than 1 gives the stage a strided 1x1 residual, the
depthwise stage ignores its stride, and the learned positions are sized from
the strided token count.  The encoder cases use the JAX package's tiny region
config (``tests/test_models.py::TINY_REGION``) at T = 64; every case but the
unit-stride control was refused by the port before strides and even kernels
were ported.  Tolerance: the region-encoder tests' atol 1e-4
(``tests/test_torch_models.py``); the single conv 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from imagined_speech_translation_tpu.models import RegionConvAttentionEncoder as JaxRegionEncoder
from imagined_speech_translation_tpu.models.folding import fold_batch_norm as jax_fold
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.models import RegionConvAttentionEncoder, fold_batch_norm
from imagined_speech_translation_tpu_torch.models.layers import (
    RegionConv,
    same_padding,
    stem_length,
)
from tests.test_models import TINY_REGION
from tests.test_torch_models import ATOL, few_threads, seeded_flax_variables  # noqa: F401

T, B, C, H = 64, 2, 6, 48

CASES = {
    "unit": dict(conv_strides=(1, 1, 1, 1, 1)),
    "s2": dict(conv_strides=(2, 1, 1, 1, 1)),
    "s22121": dict(conv_strides=(2, 2, 1, 2, 1)),
    "even-k": dict(conv_kernels=(8, 6, 4, 4, 2)),
    "even-k-s21123": dict(conv_kernels=(8, 6, 4, 4, 2), conv_strides=(2, 1, 1, 2, 3)),
    # stages 0 and 3 keep their width: the stride alone gives them a residual
    "same-width-s21121": dict(conv_channels=(6, 16, 24, 24, 48), conv_strides=(2, 1, 1, 2, 1)),
}
# pos_emb rows the JAX module makes at T = 64
POS_LEN = {"unit": 68, "s2": 36, "s22121": 12, "even-k": 68, "even-k-s21123": 10,
           "same-width-s21121": 20}


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("kernel", [1, 2, 4, 5, 9])
def test_region_conv_matches_flax_same(kernel, stride):
    """One RegionConv (two regions, grouped and not) against ``nn.Conv(padding=
    'SAME', strides=s)`` at lengths shorter than, equal to and longer than
    the kernel, odd and even."""
    rng = np.random.default_rng(kernel * 10 + stride)
    for groups, cin, cout in ((1, 3, 5), (4, 4, 4)):
        for t in (1, kernel, 16, 17, 23):
            x = rng.normal(size=(2, t, cin)).astype(np.float32)
            conv = nn.Conv(cout, (kernel,), strides=(stride,), padding="SAME",
                           feature_group_count=groups)
            ws = [rng.normal(size=(kernel, cin // groups, cout)).astype(np.float32)
                  for _ in range(2)]
            bs = [rng.normal(size=(cout,)).astype(np.float32) for _ in range(2)]
            want = np.stack([np.asarray(conv.apply({"params": {"kernel": w, "bias": b}}, x))
                             for w, b in zip(ws, bs)], axis=1)  # (B, R, T', out)
            port = RegionConv(2, cin, cout, kernel, stride=stride, groups=groups)
            with torch.no_grad():
                port.weight.copy_(torch.from_numpy(np.stack(ws).transpose(0, 3, 2, 1)))
                port.bias.copy_(torch.from_numpy(np.stack(bs)))
                xt = torch.from_numpy(np.concatenate([x, x], axis=-1)).transpose(1, 2)
                got = port(xt).reshape(2, 2, cout, -1).transpose(2, 3).numpy()
            assert got.shape == want.shape == (2, 2, -(-t // stride), cout)
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"T={t} groups={groups}")
            left, right = same_padding(t, kernel, stride)
            pads = jax.lax.padtype_to_pads((t,), (kernel,), (stride,), "SAME")
            assert (left, right) == tuple(pads[0])


def _encoders(case):
    rcfg = dataclasses.replace(TINY_REGION, **CASES[case])
    x = np.random.default_rng(2).normal(size=(B, T, C)).astype(np.float32)
    jenc = JaxRegionEncoder(rcfg, hidden_dim=H)
    variables = seeded_flax_variables(jenc, x, seed=4)
    tenc = RegionConvAttentionEncoder(rcfg, H, n_regions=1, in_channels=C, n_timepoints=T)
    load_flax_variables(tenc.eval(), jax.tree.map(lambda a: a[None], variables))
    return rcfg, x, jenc, variables, tenc


def _port_out(tenc, x):
    with torch.no_grad():
        return tenc(torch.from_numpy(x).transpose(1, 2)[:, None])[0].numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_strided_region_encoder_matches_jax(case):
    rcfg, x, jenc, variables, tenc = _encoders(case)
    assert variables["params"]["pos_emb"].shape == (1, POS_LEN[case], H)
    assert tuple(tenc.pos_emb.shape) == (1, 1, POS_LEN[case], H)
    assert stem_length(rcfg, T) + 1 + rcfg.num_temporal_tokens == POS_LEN[case]
    # a strided stage gets its residual even where the width does not change
    for i, s in enumerate(rcfg.conv_strides):
        if i != rcfg.depthwise_stage:
            assert hasattr(tenc, f"stage{i}_residual") == (f"stage{i}_residual"
                                                            in variables["params"])
    want = np.asarray(jax.jit(jenc.apply)(variables, x))
    np.testing.assert_allclose(_port_out(tenc, x), want, atol=ATOL)


def test_strided_region_encoder_folded_matches_jax():
    """BatchNorm folded into the strided convs and their strided residuals:
    the port's fold against JAX's on the same variables, and against the
    unfolded module."""
    rcfg, x, jenc, variables, tenc = _encoders("s22121")
    assert "stage3_residual" in variables["params"]  # 32 -> 48 at stride 2
    assert "stage0_residual" in variables["params"]
    folded = fold_batch_norm(tenc)
    assert torch.equal(folded.stage3_residual.bn.running_var,
                       torch.full_like(folded.stage3_residual.bn.running_var,
                                       1 - folded.stage3_residual.bn.eps))
    want = np.asarray(jax.jit(jenc.apply)(jax_fold(variables), x))
    got = _port_out(folded, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, _port_out(tenc, x), atol=ATOL)


def test_strided_stem_stays_replicated_under_tensor_parallelism():
    """The strided residuals, like every stem conv, match none of the JAX
    ``_TP_RULES``: replicated on every rank, while the wide projections
    after the stem keep their split."""
    from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
    from imagined_speech_translation_tpu_torch.parallel.mesh import _dense_modules, _tp_spec
    from tests.helpers import tiny_config, tiny_tokenizer

    cfg = tiny_config(tiny_tokenizer().vocab_size, n_timepoints=T)
    model_cfg = cfg.model
    brain = dataclasses.replace(model_cfg.brain_encoder, region_encoder=dataclasses.replace(
        model_cfg.brain_encoder.region_encoder, conv_strides=(2, 2, 1, 2, 1)))
    model = EEGDecodingModel(dataclasses.replace(model_cfg, brain_encoder=brain), T)
    dense = _dense_modules(model)
    sd = model.state_dict()
    stem = [k for k in sd if ".stage" in k]
    assert any("stage3_residual.conv.weight" in k for k in stem)
    assert all(_tp_spec(k, sd[k].dim(), dense) == () for k in stem)
    fc1 = next(k for k in sd if k.endswith("cnn_to_attn_fc1.weight"))
    assert _tp_spec(fc1, sd[fc1].dim(), dense) != ()
