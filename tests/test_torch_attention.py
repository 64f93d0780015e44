"""Port attention vs the JAX package: the flash kernel's plain twin against the
Pallas ``_fwd_kernel`` in interpret mode, the dispatching wrapper against
``ops.dot_product_attention``, and the dispatch rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import dot_product_attention as jax_attention
from imagined_speech_translation_tpu.ops.pallas_attention import flash_attention as jax_flash
from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.frontend import SignalFrontend
from imagined_speech_translation_tpu_torch.ops import (
    dot_product_attention,
    flash_attention,
    flash_attention_reference,
    flash_route,
    tile_keep_mask,
)


def _qkv(b=1, h=2, s=200, d=128, seed=0, s_kv=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, s, d)) * 0.3
    kv = [rng.normal(size=(b, h, s_kv or s, d)) * 0.3 for _ in range(2)]
    return [a.astype(np.float32) for a in (q, *kv)]


@pytest.mark.parametrize("d", [128, 256])
def test_flash_reference_matches_pallas_interpret(d):
    # S = 200 is not a multiple of the kernel's blocks
    q, k, v = _qkv(d=d, seed=d)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    out, lse = flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
    # base-2 logsumexp of the scaled scores, (b*h, S)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * d**-0.5
    m = s.max(-1, keepdims=True)
    ref_lse = (m[..., 0] + np.log(np.exp(s - m).sum(-1))) / np.log(2)
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(-1, 200), atol=2e-5)


@pytest.mark.parametrize("d", [128, 256])
def test_dot_product_attention_matches_jax(d):
    q, k, v = _qkv(d=d, seed=1)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_masked_attention_matches_jax():
    q, k, v = _qkv(b=2, h=2, s=5, d=16, seed=2, s_kv=7)
    mask = np.random.default_rng(3).random((2, 1, 5, 7)) > 0.3
    mask[..., 0] = True
    want = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = dot_product_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize(
    "s_q, s_kv, d, masked, flash",
    [
        (1655, 1655, 128, False, True),   # region self-attention
        (1655, 1655, 256, False, True),   # shared cross-scale attention
        (128, 128, 96, False, True),
        (127, 1655, 128, False, False),   # short queries stay dense
        (1655, 100, 128, False, False),
        (1655, 1655, 288, False, False),  # head dim above 256
        (1655, 1655, 128, True, False),   # masked: the kernel is unmasked-only
        (1, 16, 64, True, False),         # decode step with a KV cache
    ],
)
def test_dispatch_rule(s_q, s_kv, d, masked, flash):
    q = torch.empty((1, 1, s_q, d), device="meta")
    k = torch.empty((1, 1, s_kv, d), device="meta")
    mask = torch.ones((1, 1, s_q, s_kv), dtype=torch.bool, device="meta") if masked else None
    assert flash_route(q, k, mask) is flash


def test_flash_on_cpu_is_the_reference():
    q, k, v = map(torch.from_numpy, _qkv(s=130, d=24, seed=4))
    got, got_lse = flash_attention(q, k, v, scale=0.3)
    want, want_lse = flash_attention_reference(q, k, v, scale=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=0)


def test_flash_refuses_non_cuda_devices():
    q = torch.empty((1, 1, 128, 64), device="meta")
    with pytest.raises(ValueError, match="need one CUDA device"):
        flash_attention(q, q, q)


def test_cpu_paths_count_no_launches():
    _kernels.reset_launch_counts()
    q, k, v = (t.requires_grad_() for t in map(torch.from_numpy, _qkv(s=128, d=32, seed=5)))
    dot_product_attention(q, k, v, dropout_rate=0.1,
                          generator=torch.Generator().manual_seed(0)).sum().backward()
    dot_product_attention(q, k, v).sum().backward()  # rate 0: the split kernels on the card
    tile_keep_mask(3, 0, 0, 0, block_q=128, block_k=128, rate=0.1, device="cpu")
    SignalFrontend().preprocess(torch.zeros((2, 3, 50)))
    assert _kernels.launch_counts() == {
        "sosfilt": 0, "flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
        "dropout_mask": 0,
    }
