"""The float32 flash forward on the tensor cores in 3xTF32
(``csrc/flash_fwd.cu``'s ``flash_fwd_tf32_kernel``): its arithmetic,
emulated on the CPU, against the JAX package's interpret-mode ``_fwd_kernel``,
and the kernel sources' shared 3xTF32 header.

The emulation follows the kernel on one head: key tiles of the kernel's
width, each split between two "warps" that keep their own row max, row sum
and output, merged at the end as the kernel merges them; scores scaled after
the product; the online softmax in base 2; every product in 3xTF32 (or, for
the check that must tell them apart, in one TF32 pass).  Tolerance: out and
lse within 1e-5 of the JAX side, max |err| / max |ref| (f32 sums in another
order, and 3xTF32's dropped small x small terms below 2^-20 of a product).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from imagined_speech_translation_tpu_torch import _kernels
from tests.test_torch_split_bwd import _tf32_matmul

LOG2E = np.float32(np.log2(np.e))
S = 333
KEY_TILE = 64  # the kernel's key tile at every head dim (csrc/flash_fwd.cu: dispatch_f32)


def _emulate_forward(q, k, v, passes, keep=None, rate=0.0):
    """The kernel's out and base-2 lse for one head of float32 ``q (s_q, d)``,
    ``k, v (s_kv, d)``, with the keep mask ``keep (s_q, s_kv)`` at ``rate``."""
    s_q, d = q.shape
    s_kv = k.shape[0]
    qscale = torch.tensor(d**-0.5 * LOG2E, dtype=torch.float32)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    bk = KEY_TILE
    states = []
    for half in (0, 1):
        m = torch.full((s_q,), -1e30)
        l = torch.zeros(s_q)
        acc = torch.zeros(s_q, d)
        for kt in range(0, s_kv, bk):
            k0 = kt + half * bk // 2
            if k0 >= s_kv:
                continue  # the warp skips a half past the last key
            k1 = min(k0 + bk // 2, s_kv)  # keys past s_kv score -1e30: p = 0
            s = _tf32_matmul(q, k[k0:k1].T, passes) * qscale
            m_new = torch.maximum(m, s.max(dim=1).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = l * alpha + p.sum(dim=1)
            if keep is not None:
                p = torch.where(keep[:, k0:k1], p * inv_keep, 0.0)
            acc = acc * alpha[:, None] + _tf32_matmul(p, v[k0:k1], passes)
            m = m_new
        states.append((m, l, acc))
    (m0, l0, acc0), (m1, l1, acc1) = states
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    l = torch.clamp(l0 * a0 + l1 * a1, min=1e-30)
    return (acc0 * a0[:, None] + acc1 * a1[:, None]) / l[:, None], m + torch.log2(l)


def _inputs(d, qk_scale, seed):
    """The card check's inputs: q, k ~ N(0, qk_scale^2), v ~ N(0, 0.3^2)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(S, d)).astype(np.float32) * qk_scale for _ in range(2))
    v = rng.normal(size=(S, d)).astype(np.float32) * 0.3
    return q, k, v


def _jax_forward(q, k, v, rate=0.0, seed=0, block=None):
    """Out and lse of the JAX package's ``_fwd_kernel`` in interpret mode,
    as ``flash_attention`` calls it (one head)."""
    d = q.shape[-1]
    kw = dict(block_q=block, block_k=block) if block else {}
    out = pa.flash_attention(*(jnp.asarray(a[None, None]) for a in (q, k, v)),
                             dropout_rate=rate, dropout_seed=seed if rate else None,
                             interpret=True, **kw)
    block_q = block or 256
    block_k = block or (256 if rate else 384)
    _, lse = pa._fwd_call(*(jnp.asarray(a[None]) for a in (q, k, v)),
                          jnp.full((1, 128), seed, jnp.int32), block_q=block_q, block_k=block_k,
                          kv_len=S, scale=d**-0.5, dropout_rate=rate, interpret=True)
    return np.asarray(out)[0, 0], np.asarray(lse)[0, 0, :S]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("inputs, qk_scale", [("flat", 0.3), ("peaky", 1.0)])
@pytest.mark.parametrize("d", [24, 128, 256])
def test_3xtf32_forward_matches_the_jax_kernel(d, inputs, qk_scale):
    """Out and lse of the emulated kernel within 1e-5 of the JAX forward;
    the same emulation with one TF32 pass must lie beyond the card check's
    1e-4 bound or, where it does not, beyond 4x the 3xTF32 error, as
    ``chip_smoke.py`` holds the kernel against the one-pass plain twin."""
    q, k, v = _inputs(d, qk_scale, seed=d)
    want, want_lse = _jax_forward(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _emulate_forward(tq, tk, tv, passes=3)
    err = _rel(out, want)
    assert err <= 1e-5
    assert _rel(lse, want_lse) <= 1e-5
    one_pass = _rel(_emulate_forward(tq, tk, tv, passes=1)[0], want)
    assert one_pass > 1e-4 or one_pass > 4 * err, (one_pass, err)


@pytest.mark.parametrize("d", [24, 128, 256])
def test_3xtf32_forward_with_dropout_matches_the_jax_kernel(d):
    """Rate 0.1 with the keep bits of ``dropout_keep_mask_reference`` on
    128 x 128 logical tiles: out and lse within 1e-5 of the JAX forward at
    the same seed, rate and tiles, and farther than that without the mask."""
    rate, seed = 0.1, 1234
    q, k, v = _inputs(d, 0.3, seed=100 + d)
    want, want_lse = _jax_forward(q, k, v, rate=rate, seed=seed, block=128)
    keep = torch.from_numpy(np.array(pa.dropout_keep_mask_reference(
        seed, 1, 1, S, S, block_q=128, block_k=128, rate=rate))[0, 0])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _emulate_forward(tq, tk, tv, passes=3, keep=keep, rate=rate)
    assert _rel(out, want) <= 1e-5
    assert _rel(lse, want_lse) <= 1e-5
    assert _rel(_emulate_forward(tq, tk, tv, passes=3)[0], want) > 1e-4


def _c_params(source, entry):
    """Parameter types of the C entry point ``entry`` in ``csrc/<source>``."""
    text = (_kernels.CSRC / source).read_text()
    params = re.search(rf"^int {entry}\(([^)]*)\)", text, re.M).group(1)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]


def test_forward_entry_point_keeps_its_argument_types():
    assert _c_params("flash_fwd.cu", "ist_flash_fwd") == [
        "const void*", "const void*", "const void*", "void*", "float*", "int", "int", "int",
        "int", "float", "int", "int", "int", "unsigned", "int", "int", "float", "int", "int",
        "int", "int", "void*"]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert _kernels._SIGNATURES["ist_flash_fwd"] == [
        P, P, P, P, P, I, I, I, I, F, I, I, I, ctypes.c_uint, I, I, F, I, I, I, I, P]


@pytest.mark.parametrize("source", ["flash_fwd.cu", "flash_bwd_split.cu"])
def test_3xtf32_helpers_live_in_one_header(source):
    """Both 3xTF32 kernel sources include ``tf32.cuh``, which the library's
    hash covers, and neither defines the helpers itself."""
    assert "tf32.cuh" in _kernels.HEADERS
    text = (_kernels.CSRC / source).read_text()
    assert '#include "tf32.cuh"' in text
    header = (_kernels.CSRC / "tf32.cuh").read_text()
    for helper in ("struct FragA", "void mma_3xtf32(", "void scores_3xtf32(",
                   "void grads_3xtf32(", "void load_rows(", "void store_frag_rows("):
        assert helper in header and helper not in text, helper
