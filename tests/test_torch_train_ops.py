"""The training path's ops against the JAX package: the dropout keep-mask
(bit for bit against ``dropout_keep_mask_reference``), flash attention with
dropout (out, lse and the gradients against the interpret-mode Pallas
kernels and ``jax.vjp``), the attention wrapper's dropout routes, dropout
itself, and BatchNorm in train mode against ``flax.linen.BatchNorm``.

All on the CPU, where the port's wrappers run their plain twins.
Tolerances: the mask is exact; flash attention in float32 within 1e-5
(the same sums in another order); BatchNorm within 1e-5.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from imagined_speech_translation_tpu_torch.models.layers import RegionNorm
from imagined_speech_translation_tpu_torch.ops import (
    dot_product_attention,
    dropout,
    dropout_keep_mask_reference,
    flash_attention,
    tile_keep_mask,
)
from imagined_speech_translation_tpu_torch.ops.dropout_mask import dropout_blocks, hash_bits
from imagined_speech_translation_tpu_torch.ops.random import draw_seed


@pytest.mark.parametrize("seed, s_q, s_kv, block_q, block_k", [
    (0, 200, 333, 128, 128),
    (1234, 130, 700, 256, 512),
    (-7, 1655 // 4, 1655 // 4, 256, 256),
    (2**31 - 1, 129, 257, 128, 256),
    (-(2**31), 64, 600, 128, 512),
])
def test_keep_mask_matches_jax_oracle(seed, s_q, s_kv, block_q, block_k):
    kw = dict(block_q=block_q, block_k=block_k, rate=0.1)
    want = np.asarray(pa.dropout_keep_mask_reference(seed, 1, 2, s_q, s_kv, **kw))
    got = dropout_keep_mask_reference(seed, 1, 2, s_q, s_kv, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - 0.9) < 0.01


def test_hash_bits_matches_jax():
    tile = np.asarray([0, 1, 70000, 2**31 - 1], np.int64)[:, None]
    index = np.arange(0, 2**17, 37, dtype=np.int64)[None, :]
    for seed in (0, 77, -1):
        want = np.stack([np.asarray(pa._hash_bits(jnp.int32(seed), jnp.int32(t), (1, 1)))
                         for t in (0, 1, 70000, 2**31 - 1)])
        got = hash_bits(seed, torch.from_numpy(tile), torch.zeros((1, 1), dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy(), want.reshape(4, 1).astype(np.int64))
        full = hash_bits(seed, torch.from_numpy(tile), torch.from_numpy(index))
        assert full.min() >= 0 and full.max() < 2**32


def test_tile_probe_twin_is_the_dense_mask():
    dense = dropout_keep_mask_reference(77, 1, 4, 600, 700, block_q=256, block_k=512, rate=0.1)
    tile = tile_keep_mask(77, 3, 1, 1, block_q=256, block_k=512, rate=0.1, device="cpu")
    np.testing.assert_array_equal(tile[:, : 700 - 512].bool().numpy(),
                                  dense[0, 3, 256:512, 512:].numpy())


@pytest.mark.parametrize("s_q, s_kv, dtype, want", [
    (1655, 1655, torch.bfloat16, (256, 512)),
    (1655, 1655, torch.float32, (256, 256)),
    (200, 333, torch.float32, (256, 256)),
    (100, 100, torch.bfloat16, (128, 128)),
])
def test_dropout_blocks_are_the_jax_defaults(s_q, s_kv, dtype, want):
    assert dropout_blocks(96, s_q, s_kv, dtype) == want
    with pytest.raises(ValueError, match="batch\\*heads"):
        dropout_blocks(32768, s_q, s_kv, dtype)


def test_tile_id_limit_raises_like_jax():
    q = np.zeros((1, 1, 256 * 128 + 1, 8), np.float32)
    k = np.zeros((1, 1, 128, 8), np.float32)
    with pytest.raises(ValueError, match="tile-id packing"):
        pa.flash_attention(q, k, k, dropout_rate=0.1, dropout_seed=1, block_q=128,
                           interpret=True)
    with pytest.raises(ValueError, match="tile-id packing"):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                        dropout_rate=0.1, dropout_seed=1, block_q=128)


def _qkvg(shape, s_kv):
    """q, k, v and the output gradient for a ``(b, h, s_q, d)`` query shape."""
    rng = np.random.default_rng(0)
    b, h, _, d = shape
    kv = (b, h, s_kv, d)
    return [rng.normal(size=s).astype(np.float32) for s in (shape, kv, kv, shape)]


# lengths that are not multiples of 64 or 128 (the bf16 CUDA kernel's query
# and key tiles): partial tiles at both ends and a query range shorter than
# one tile, with the keep-mask's logical tiles cut at the same edges
@pytest.mark.parametrize("rate, shape, s_kv", [
    pytest.param(0.1, (2, 2, 200, 40), 200, id="0.1"),
    pytest.param(0.0, (2, 2, 200, 40), 200, id="0.0"),
    pytest.param(0.1, (1, 2, 193, 16), 193, id="0.1-s193-d16"),
    pytest.param(0.0, (1, 2, 193, 16), 193, id="0.0-s193-d16"),
    pytest.param(0.1, (1, 1, 77, 32), 193, id="0.1-q77-kv193-d32"),
])
def test_flash_with_dropout_matches_interpret_kernels(rate, shape, s_kv):
    q, k, v, g = _qkvg(shape, s_kv)
    b, h, s_q, d = shape
    seed = 123 if rate else None
    kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=128, block_k=128)
    out, vjp = jax.vjp(lambda *a: pa.flash_attention(*a, **kw, interpret=True), q, k, v)
    dq, dk, dv = vjp(g)
    seed_row = jnp.full((1, 128), seed or 0, jnp.int32)
    _, lse = pa._fwd_call(q.reshape(b * h, s_q, d), k.reshape(b * h, s_kv, d),
                          v.reshape(b * h, s_kv, d), seed_row, block_q=128, block_k=128,
                          kv_len=s_kv, scale=d**-0.5, dropout_rate=rate, interpret=True)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout, tlse = flash_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(tlse.detach().numpy(), np.asarray(lse)[:, 0, :s_q], atol=1e-5)
    for got, want in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_flash_route_draws_its_seed_from_the_generator():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 128, 16)).astype(np.float32))
               for _ in range(3))
    got = dot_product_attention(q, k, v, dropout_rate=0.1,
                                generator=torch.Generator().manual_seed(9))
    seed = draw_seed(torch.Generator().manual_seed(9))
    want = flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=seed)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 <= seed < 2**31 - 1
    with pytest.raises(ValueError, match="requires a generator"):
        dot_product_attention(q, k, v, dropout_rate=0.1)


@pytest.mark.parametrize("s, mask", [(16, None), (130, "causal")])
def test_softmax_route_dropout_is_seeded_and_unbiased(s, mask):
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, s, 8)).astype(np.float32))
               for _ in range(3))
    m = None if mask is None else torch.ones(s, s, dtype=torch.bool).tril()
    plain = dot_product_attention(q, k, v, m)

    def run(seed):
        return dot_product_attention(q, k, v, m, dropout_rate=0.1,
                                     generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    mean = torch.stack([run(i) for i in range(100)]).mean(0)
    assert (mean - plain).abs().max() < 0.15 * plain.abs().max()


def test_dropout_is_flax_dropout_in_distribution():
    x = torch.ones(200_000)
    assert dropout(x, 0.1, None) is x
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    torch.testing.assert_close(y, dropout(x, 0.1, torch.Generator().manual_seed(0)))


def test_batch_norm_train_mode_matches_flax():
    rng = np.random.default_rng(3)
    R, C, B, T = 2, 5, 3, 11
    x = (rng.normal(size=(B, R * C, T)) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.normal(size=(R, C)).astype(np.float32) for _ in range(2))
    mean0 = rng.normal(size=(R, C)).astype(np.float32)
    var0 = (np.abs(rng.normal(size=(R, C))) + 0.5).astype(np.float32)
    norm = RegionNorm(R, C, "batch", 1).train()
    with torch.no_grad():
        for t, a in ((norm.weight, scale), (norm.bias, bias), (norm.running_mean, mean0),
                     (norm.running_var, var0)):
            t.copy_(torch.from_numpy(a))
        got = norm(torch.from_numpy(x)).numpy()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    apply = jax.jit(functools.partial(bn.apply, mutable=["batch_stats"]))
    for r in range(R):
        xr = x[:, r * C:(r + 1) * C].transpose(0, 2, 1)  # (B, T, C)
        y, upd = apply({"params": {"scale": scale[r], "bias": bias[r]},
                        "batch_stats": {"mean": mean0[r], "var": var0[r]}}, xr)
        np.testing.assert_allclose(got[:, r * C:(r + 1) * C], np.asarray(y).transpose(0, 2, 1),
                                   atol=1e-5)
        np.testing.assert_allclose(norm.running_mean[r].numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(norm.running_var[r].numpy(),
                                   np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    # the stored variance is the biased one, where F.batch_norm keeps the unbiased
    biased = x.reshape(B, R, C, T).transpose(1, 2, 0, 3).reshape(R, C, -1).var(-1)
    np.testing.assert_allclose(norm.running_var.numpy(), 0.9 * var0 + 0.1 * biased, rtol=1e-5)
