"""The bf16 split dQ kernel's arithmetic (``flash_bwd_dq_wgmma_kernel`` of
``csrc/flash_bwd_split.cu``) held to the JAX package's ``_bwd_dq_kernel``
(through ``_bwd_call_split`` in interpret mode) on the CPU.

The emulation follows the kernel on one head: 128-query blocks against
64-key tiles, K and V zero past s_kv and those keys scoring -inf, S = Q K^T
in float32 from the bf16 Q and K (Q not pre-scaled: the float32 S is scaled
by scale * log2 e), P = exp2(S' - lse), dS = P (dP - delta) rounded to bf16
before dQ += dS K in float32, tile after tile, and dQ = scale * acc rounded
to bf16 at the end.  Bound: max |err| / max |ref| 2e-2, the card check's
bf16 bound for the split backward; the emulation without the delta term
must lie beyond it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from tests.test_torch_models import few_threads  # noqa: F401

S_Q, S_KV = 200, 333


def _round_up(n, m):
    return -(-n // m) * m


def emulate_dq(q, k, v, dout, lse, delta, scale, with_delta=True):
    """dQ of one head as the bf16 kernel computes it: q, dout (s_q, d) and
    k, v (s_kv, d) in bf16, lse (base 2) and delta float32 (s_q,)."""
    s_q, d = q.shape
    s_kv = k.shape[0]
    q_pad, kv_pad = _round_up(s_q, 128), _round_up(s_kv, 64)
    qf = torch.zeros(q_pad, d)
    dof = torch.zeros(q_pad, d)
    qf[:s_q], dof[:s_q] = q.float(), dout.float()
    kf = torch.zeros(kv_pad, d)
    vf = torch.zeros(kv_pad, d)
    kf[:s_kv], vf[:s_kv] = k.float(), v.float()
    lse_p = torch.zeros(q_pad)
    delta_p = torch.zeros(q_pad)
    lse_p[:s_q] = lse
    if with_delta:
        delta_p[:s_q] = delta
    qscale = scale * np.log2(np.e)
    acc = torch.zeros(q_pad, d)
    for k0 in range(0, kv_pad, 64):
        kt, vt = kf[k0:k0 + 64], vf[k0:k0 + 64]
        s = (qf @ kt.T) * np.float32(qscale)
        s[:, torch.arange(k0, k0 + 64) >= s_kv] = -1e30
        p = torch.exp2(s - lse_p[:, None])
        ds = p * (dof @ vt.T - delta_p[:, None])
        acc += ds.to(torch.bfloat16).float() @ kt
    return (acc * np.float32(scale)).to(torch.bfloat16)[:s_q]


@pytest.mark.parametrize("d", [16, 128, 256])
def test_bf16_dq_emulation_matches_the_jax_split_kernel(d):
    rng = np.random.default_rng(d + 7)
    bh = 2
    q = rng.normal(size=(bh, S_Q, d)) * 0.3
    k = rng.normal(size=(bh, S_KV, d)) * 0.3
    v = rng.normal(size=(bh, S_KV, d)) * 0.3 + 0.5  # a mean that makes the delta term count
    g = rng.normal(size=(bh, S_Q, d))
    qj, kj, vj, gj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    scale = d**-0.5
    seed = jnp.zeros((1, 128), jnp.int32)
    block_q, block_k = min(256, _round_up(S_Q, 128)), _round_up(S_KV, 128)
    blocks = dict(block_q=block_q, block_k=block_k, kv_len=S_KV, scale=scale,
                  dropout_rate=0.0, interpret=True)
    out, lse = pa._fwd_call(qj, kj, vj, seed, **blocks)
    delta = jnp.sum(gj.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)[:, None, :]
    want = pa._bwd_call_split(qj, kj, vj, gj, lse, delta, seed, **blocks)[0]
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))

    lse_t = torch.from_numpy(np.array(lse, np.float32)).reshape(bh, -1)[:, :S_Q]
    delta_t = torch.from_numpy(np.array(delta, np.float32)).reshape(bh, S_Q)
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in (qj, kj, vj, gj))
    top = want.abs().max()
    for with_delta in (True, False):
        got = torch.stack([emulate_dq(tq[i], tk[i], tv[i], tg[i], lse_t[i], delta_t[i], scale,
                                      with_delta) for i in range(bh)])
        err = ((got.float() - want).abs().max() / top).item()
        if with_delta:
            assert err <= 2e-2, err
        else:
            assert err > 2e-2, err
