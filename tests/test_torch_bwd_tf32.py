"""The float32 fused backward on the tensor cores in 3xTF32
(``csrc/flash_bwd_tf32.cuh``'s ``flash_bwd_tf32_kernel``, launched by
``csrc/flash_bwd.cu``): its arithmetic, emulated on the CPU, against the JAX
package's interpret-mode ``_bwd_fused_kernel``; its index arithmetic (the
hoisted dropout mask, the dS hand-over to the dQ product); and its C entry
point and headers.

The emulation follows the kernel on one head: blocks of 64 keys (4 warp
pairs of 16 keys), each looping over 32-query tiles from a start staggered
by its key tile; per pair, S^T, P~^T and dV += P~^T dO in one "warp", dP^T,
dS^T and dK += dS^T Q in the other; per block and tile, the dQ partial dS K
added, scaled, into a float32 dQ, so dQ sums the key blocks' partials in
f32; every product in 3xTF32 (or, for the check that must tell them apart,
in one TF32 pass).  Tolerance: dQ, dK and dV within 1e-5 of the JAX side,
max |err| / max |ref| (f32 sums in another order, and 3xTF32's dropped
small x small terms below 2^-20 of a product).
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.ops import pallas_attention as pa
from imagined_speech_translation_tpu_torch import _kernels
from imagined_speech_translation_tpu_torch.ops.dropout_mask import dropout_threshold
from tests.test_torch_split_bwd import _tf32_matmul

LOG2E = np.float32(np.log2(np.e))
S_Q, S_KV = 200, 333  # ragged: a partial query tile and a partial key block
RATE, SEED, BLOCK = 0.1, 1234, 128
NG, BQ = 4, 32  # the kernel's warp pairs (16 keys each) and query tile (csrc/flash_bwd.cu)


def _emulate_backward(q, k, v, dout, lse, delta, keep, passes, rate=RATE):
    """dQ, dK, dV of the kernel for one head: float32 ``q, dout (s_q, d)``,
    ``k, v (s_kv, d)``, the base-2 ``lse`` and ``delta (s_q,)``, and the keep
    mask ``keep (s_q, s_kv)`` at ``rate``."""
    s_q, d = q.shape
    s_kv = k.shape[0]
    scale = torch.tensor(d**-0.5, dtype=torch.float32)
    qscale = torch.tensor(d**-0.5 * LOG2E, dtype=torch.float32)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    dq = torch.zeros(s_q, d)
    dk, dv = torch.zeros(s_kv, d), torch.zeros(s_kv, d)
    n_qt = -(-s_q // BQ)
    for kb, k0 in enumerate(range(0, s_kv, 16 * NG)):
        pairs = [(g0, min(g0 + 16, s_kv)) for g0 in range(k0, k0 + 16 * NG, 16) if g0 < s_kv]
        for it in range(n_qt):
            q0 = (kb + it) % n_qt * BQ  # blocks start apart
            q1 = min(q0 + BQ, s_q)
            qt, dot = q[q0:q1], dout[q0:q1]
            ds_t = []
            for g0, g1 in pairs:
                kp = keep[q0:q1, g0:g1].T
                p_t = torch.exp2(_tf32_matmul(k[g0:g1], qt.T, passes) * qscale - lse[None, q0:q1])
                pt_t = torch.where(kp, p_t * inv_keep, 0.0)
                dv[g0:g1] += _tf32_matmul(pt_t, dot, passes)
                dp_t = torch.where(kp, _tf32_matmul(v[g0:g1], dot.T, passes) * inv_keep, 0.0)
                ds = p_t * (dp_t - delta[None, q0:q1])
                dk[g0:g1] += _tf32_matmul(ds, qt, passes)
                ds_t.append(ds)
            k1 = pairs[-1][1]
            dq[q0:q1] += _tf32_matmul(torch.cat(ds_t).T, k[k0:k1], passes) * scale
    return dq, dk * scale, dv


def _inputs(d, seed):
    """The card check's training inputs: q, k, v ~ N(0, 0.3^2), dO ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S_Q, d)).astype(np.float32) * 0.3
    k, v = (rng.normal(size=(S_KV, d)).astype(np.float32) * 0.3 for _ in range(2))
    dout = rng.normal(size=(S_Q, d)).astype(np.float32)
    return q, k, v, dout


def _jax_backward(q, k, v, dout):
    """dQ, dK, dV of the JAX package's fused backward (interpret mode, one
    head, rate 0.1 on 128 x 128 logical tiles), and the lse and delta it
    takes: the forward's base-2 lse and rowsum(dO * O)."""
    d = q.shape[-1]
    kw = dict(dropout_rate=RATE, dropout_seed=SEED, block_q=BLOCK, block_k=BLOCK)
    args = [jnp.asarray(a[None, None]) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda *a: pa.flash_attention(*a, **kw, interpret=True), *args)
    grads = [np.asarray(g)[0, 0] for g in vjp(jnp.asarray(dout[None, None]))]
    _, lse = pa._fwd_call(*(jnp.asarray(a[None]) for a in (q, k, v)),
                          jnp.full((1, 128), SEED, jnp.int32), block_q=BLOCK, block_k=BLOCK,
                          kv_len=S_KV, scale=d**-0.5, dropout_rate=RATE, interpret=True)
    delta = (dout * np.asarray(out)[0, 0]).sum(axis=-1)
    return grads, np.asarray(lse)[0, 0, :S_Q], delta


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d", [24, 128, 256])
def test_3xtf32_fused_backward_matches_the_jax_kernel(d):
    """dQ, dK and dV of the emulated kernel within 1e-5 of the JAX fused
    backward at rate 0.1 with ``dropout_keep_mask_reference``'s bits; the
    same emulation with one TF32 pass beyond the card check's 1e-4 bound, and
    without the mask farther than that too."""
    q, k, v, dout = _inputs(d, seed=200 + d)
    want, lse, delta = _jax_backward(q, k, v, dout)
    keep = torch.from_numpy(np.array(pa.dropout_keep_mask_reference(
        SEED, 1, 1, S_Q, S_KV, block_q=BLOCK, block_k=BLOCK, rate=RATE))[0, 0])
    args = [torch.from_numpy(np.array(a, np.float32)) for a in (q, k, v, dout, lse, delta)]
    got = _emulate_backward(*args, keep=keep, passes=3)
    errs = [_rel(a, w) for a, w in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    one_pass = [_rel(a, w) for a, w in zip(_emulate_backward(*args, keep=keep, passes=1), want)]
    assert min(one_pass) > 1e-4, one_pass
    no_mask = _emulate_backward(*args, keep=torch.ones_like(keep), passes=3, rate=0.0)
    assert min(_rel(a, w) for a, w in zip(no_mask, want)) > 1e-4


def _mix(x):
    """The hash's finaliser (``dropout_mix``) on uint32 numpy arrays."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _tile_base(bh, row0, col0, block_q, block_k):
    """``dropout_tile_base`` (without the seed's term)."""
    qi, ki = row0 // block_q, col0 // block_k
    tile_id = np.uint32((bh * 256 + qi) * 256 + ki)
    index = np.uint32((row0 - qi * block_q) * block_k + col0 - ki * block_k)
    return index + np.uint32(0x9E3779B9) * tile_id


@pytest.mark.parametrize("block_q, block_k", [(128, 128), (256, 256), (96, 160)])
def test_hoisted_mask_gives_the_reference_bits(block_q, block_k):
    """The dV warp's keep bits with the hash input hoisted to its 16-key x
    32-query slice, as the kernel forms them (slice base, then 2t rows and g
    columns per lane, then 8n + e % 2 rows and 8 (e / 2) columns per
    accumulator element), equal ``dropout_keep_mask_reference``'s bits on
    tilings where the kernel hoists (block_q % 32 == 0, block_k % 16 == 0)."""
    bh, s_q, s_kv = 3, 2 * block_q, 2 * block_k
    assert block_q % BQ == 0 and block_k % 16 == 0
    want = np.array(pa.dropout_keep_mask_reference(SEED, 1, bh + 1, s_q, s_kv, block_q=block_q,
                                                   block_k=block_k, rate=RATE))[0, bh]
    seed_mix = np.uint32((0x85EBCA6B * SEED) % 2**32)
    threshold = dropout_threshold(RATE)
    got = np.zeros((s_q, s_kv), bool)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    bk = np.uint32(block_k)
    with np.errstate(over="ignore"):
        for q0 in range(0, s_q, BQ):
            for key0 in range(0, s_kv, 16):
                base = (_tile_base(bh, q0, key0, block_q, block_k) + seed_mix
                        + (2 * t).astype(np.uint32) * bk + g.astype(np.uint32))
                for n in range(BQ // 8):
                    for e in range(4):
                        off = np.uint32(8 * n + (e & 1)) * bk + np.uint32(8 * (e >> 1))
                        rows = q0 + 8 * n + 2 * t + (e & 1)
                        cols = key0 + g + 8 * (e >> 1)
                        got[rows, cols] = _mix(base + off) >= threshold
    np.testing.assert_array_equal(got, want)


def _pair_slot(n, e, lane):
    """``pair_slot<true>`` of ``csrc/flash_bwd_tf32.cuh``."""
    return (4 * n + e) * 32 + (lane ^ 4 if e & 1 else lane)


def test_ds_handover_reads_ds_as_the_dq_products_a_operand():
    """The dK warps write dS^T into their pairs' buffers at ``pair_slot``
    from the accumulator layout (pair p, lane 4g + t, element e of n-tile n:
    key 16p + g + 8 (e / 2), query 8n + 2t + e % 2); ``dq_partial`` reads each
    A fragment of dS (query m-tile mt, 8-key slice kk) with the contraction
    slots permuted (slot t: key 2t, slot t + 4: key 2t + 1) from offsets
    ``(2 (kk % 2) + g % 2) * 32 + 8 mt * 32 (+ 128 for rows g + 8)`` plus the
    swizzled lanes ``l0, l1``.  It must read dS[query][key] at every slot,
    and each of its loads must hit 32 distinct banks, as must the writes."""
    ds_t = np.arange(16 * NG * BQ, dtype=np.int64).reshape(16 * NG, BQ) * 7 + 3
    buf = np.full(NG * 16 * BQ, -1, np.int64)
    for p in range(NG):
        for n in range(BQ // 8):
            for e in range(4):
                slots = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    slot = p * 16 * BQ + _pair_slot(n, e, lane)
                    buf[slot] = ds_t[16 * p + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)]
                    slots.append(slot % 32)
                assert len(set(slots)) == 32
    assert (buf >= 0).all()
    for kk in range(2 * NG):
        for mt in range(BQ // 16):
            frags = {j: [] for j in range(4)}  # a0 (g, 2t), a1 (g + 8, 2t), a2, a3 (key 2t + 1)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                odd = g & 1
                l0, l1 = (8 * t + g // 2) ^ (4 * odd), (8 * t + 4 + g // 2) ^ (4 * odd)
                src = (kk // 2) * 16 * BQ + (2 * (kk % 2) + odd) * 32 + 8 * mt * 32
                for j, off in enumerate((l0, 128 + l0, l1, 128 + l1)):
                    query = 16 * mt + g + 8 * (j % 2)
                    key = 8 * kk + 2 * t + j // 2
                    assert buf[src + off] == ds_t[key, query], (kk, mt, lane, j)
                    frags[j].append((src + off) % 32)
            assert all(len(set(banks)) == 32 for banks in frags.values())


def _c_params(source, entry):
    """Parameter types of the C entry point ``entry`` in ``csrc/<source>``."""
    text = (_kernels.CSRC / source).read_text()
    params = re.search(rf"^int {entry}\(([^)]*)\)", text, re.M).group(1)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in params.split(",")]


def test_fused_entry_point_keeps_its_argument_types():
    assert _c_params("flash_bwd.cu", "ist_flash_bwd") == [
        "const void*", "const void*", "const void*", "const void*", "const float*",
        "const float*", "float*", "void*", "void*", "int", "int", "int", "int", "float", "float",
        "int", "int", "int", "unsigned", "int", "int", "float", "int", "int", "int", "int",
        "void*"]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    assert _kernels._SIGNATURES["ist_flash_bwd"] == [
        P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, I, I, I, ctypes.c_uint, I, I, F,
        I, I, I, I, P]


@pytest.mark.parametrize("source", ["flash_bwd.cu", "flash_bwd_split.cu"])
def test_both_backward_sources_share_the_3xtf32_template(source):
    """The fused and the split dK/dV f32 backward come from one template in
    ``flash_bwd_tf32.cuh``, which the library's hash covers; neither source
    defines the kernel itself."""
    assert "flash_bwd_tf32.cuh" in _kernels.HEADERS
    text = (_kernels.CSRC / source).read_text()
    assert '#include "flash_bwd_tf32.cuh"' in text
    assert "flash_bwd_tf32_kernel(" not in text
    header = (_kernels.CSRC / "flash_bwd_tf32.cuh").read_text()
    for piece in ("flash_bwd_tf32_kernel(", "void dq_partial(", "void red_dq(",
                  "int launch_bwd_tf32(", "int launch_dkv_tf32(", "bool tf32_fits("):
        assert piece in header, piece


def test_tuning_program_times_the_fused_source():
    """``cli/tune_split_bwd.py --program bwd_tf32`` builds a program that
    includes the fused kernel's source, so it times what the library runs."""
    from imagined_speech_translation_tpu_torch.cli import tune_split_bwd

    src = (_kernels.CSRC / "tune" / "bwd_tf32.cu").read_text()
    assert '#include "../flash_bwd.cu"' in src
    with pytest.raises(SystemExit):
        tune_split_bwd.main(["--program", "no_such_program"])
    assert "bwd_tf32" in tune_split_bwd.__doc__
