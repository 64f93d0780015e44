"""On-card verification and timing of the flash-attention kernels.

Port of ``tools/tpu_kernel_check.py``.  The CPU tests hold the kernels'
arithmetic to JAX; this gate is the hardware half: every numerics check
carries a hard bound (the JAX tool's, unchanged) and the run fails (rc 1)
if one is exceeded.  Results (errors, bounds, pass flags, TFLOP/s) go to a
JSON file with ``--json``.

Checks, on ``--device`` (the card by default; ``cpu`` runs every check on
the kernels' plain twins):

* the flash forward (``csrc/flash_fwd.cu``) against the plain attention
  (``ops.attention._softmax_attention``) in float32 and bfloat16, at
  (2, 4, 333, 96) and at head dim 128;
* the rate-0 backward (the split kernels, ``csrc/flash_bwd_split.cu``)
  against autograd through the plain attention;
* the keep fraction of the probe kernel (``csrc/dropout_mask.cu`` through
  ``ops.dropout_mask.tile_keep_mask``) at rates 0.1 and 0.5 on the JAX
  tool's tile: (256, 512), seed 77, tile (3, 1, 2);
* dropout (the forward and the fused backward ``csrc/flash_bwd.cu``):
  determinism given the seed, seed sensitivity, the mean over seeds
  converging to the plain output, finite gradients, and continuity as the
  rate goes to 0;
* timing at the JAX tool's shapes, (16, 8, 1655, 96) and (16, 6, 1655,
  128), f32 and bf16: the forward, forward + backward at rate 0 and at rate
  0.1, by CUDA events, beside the card's ``nvidia-smi`` name and power
  limit (the card only; skipped with ``--quick``).

The gate's check names are the JAX tool's.  ``port_checks`` holds what the
port adds: the probe's bits against its plain twin bit for bit, the
determinism check's parts, and the rate-to-zero route.

``fused_bwd_deterministic_given_seed`` differs from the JAX check in one
respect.  The fused backward adds each key tile's share of dQ with float
atomics (``csrc/flash_bwd_kv.cuh``, ``csrc/flash_bwd_tf32.cuh``), so two
launches may sum dQ in another order and differ in its last bits.  What the
check exists to catch is a mask regenerated otherwise from launch to launch.
So what the kernels write once -- the forward's output, dK and dV -- and the
probe's mask tile must be equal bit for bit over two launches, and dQ lie within
:data:`DQ_ATOMIC_REL` of max |dQ|.

Usage::

    python -m imagined_speech_translation_tpu_torch.cli.kernel_check \\
        [--quick] [--json KERNELCHECK.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import _kernels
from ..ops.attention import _softmax_attention
from ..ops.dropout_mask import (
    dropout_threshold,
    tile_keep_mask,
    tile_keep_mask_reference,
)
from ..ops.flash_attention import backward_route, flash_attention
from ..utils.cache import enable_persistent_cache
from .profile_slice import card_line

#: the JAX tool's probe tile: (256, 512) at seed 77, tile ids (3, 1, 2)
PROBE_TILE = dict(bh=3, qi=1, ki=2, block_q=256, block_k=512)
PROBE_SEED = 77
TIMING_SHAPES = {
    "ref_h8_d96": (16, 8, 1655, 96),
    "default_h6_d128": (16, 6, 1655, 128),
}
#: dQ of two fused-backward launches, max |dQ1 - dQ2| / max |dQ|.  The key
#: tiles' shares of dQ meet in float32 atomic adds whose order is the
#: schedule's; at (2, 4, 333, 96) a dQ row sums a handful of tile shares,
#: so two orders can round apart by a few float32 ulps of the row's
#: largest share (2**-24 each, about 6e-8).  The spread measured on an H100
#: 80GB HBM3 (700 W) was 0.0: the adds met in the same order in both
#: launches.  The bound allows about 16 ulps for a schedule that reorders
#: them; a mask regenerated otherwise moves dQ by the dropped
#: probabilities' terms, a relative 1e-2 and more, far beyond it.
DQ_ATOMIC_REL = 1e-6


class Gate:
    """Collects named checks; each is (value, bound, ok)."""

    def __init__(self):
        self.checks: dict[str, dict] = {}

    def leq(self, name: str, value: float, bound: float):
        ok = bool(value <= bound)
        self.checks[name] = {"value": float(value), "bound": bound, "ok": ok}
        flag = "ok" if ok else "FAIL"
        print(f"[{flag}] {name}: {value:.3e} (bound {bound:.1e})")
        return ok

    def true(self, name: str, cond: bool):
        self.checks[name] = {"value": bool(cond), "bound": True, "ok": bool(cond)}
        print(f"[{'ok' if cond else 'FAIL'}] {name}: {bool(cond)}")
        return cond

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks.values())


def _attn(q, k, v, **kw):
    return flash_attention(q, k, v, **kw)[0]


def _plain(q, k, v):
    return _softmax_attention(q, k, v, None, q.shape[-1] ** -0.5)


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _rel(a, b) -> float:
    return _max_abs(a, b) / float(b.float().abs().max())


def _grads(fn, q, k, v):
    """Gradients of ``(fn(q, k, v) ** 2).sum()`` in ``q, k, v``."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (fn(*leaves).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


def check(device: torch.device, *, quick: bool = False, block_q=None, block_k=None):
    """The numerics checks; returns ``(gate, port_gate)``."""
    gate, port = Gate(), Gate()
    blocks = dict(block_q=block_q, block_k=block_k)
    rng = np.random.default_rng(0)

    def normal(shape, dtype=torch.float32):
        return torch.as_tensor(rng.normal(size=shape) * 0.3, dtype=torch.float32,
                               device=device).to(dtype)

    # ---- numerics (an odd length exercises the boundary masking) ------
    q, k, v = (normal((2, 4, 333, 96)) for _ in range(3))
    ref = _plain(q, k, v)
    gate.leq("fwd_f32_max_err", _max_abs(ref, _attn(q, k, v, **blocks)), 5e-4)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    gate.leq("fwd_bf16_max_err", _max_abs(_plain(qb, kb, vb), _attn(qb, kb, vb, **blocks)),
             3e-2)

    # ---- at the default head shape (d = 128) --------------------------
    q8, k8, v8 = (normal((2, 6, 333, 128)) for _ in range(3))
    gate.leq("fwd_f32_d128_max_err", _max_abs(_plain(q8, k8, v8), _attn(q8, k8, v8, **blocks)),
             5e-4)
    q8b, k8b, v8b = (t.to(torch.bfloat16) for t in (q8, k8, v8))
    gate.leq("fwd_bf16_d128_max_err",
             _max_abs(_plain(q8b, k8b, v8b), _attn(q8b, k8b, v8b, **blocks)), 3e-2)
    gf8 = _grads(lambda *a: _attn(*a, **blocks), q8, k8, v8)
    gr8 = _grads(_plain, q8, k8, v8)
    for name, a, b in zip("qkv", gf8, gr8):
        gate.leq(f"split_bwd_d128_d{name}_rel_err", _rel(a, b), 2e-2)

    gf = _grads(lambda *a: _attn(*a, **blocks), q, k, v)
    gr = _grads(_plain, q, k, v)
    for name, a, b in zip("qkv", gf, gr):
        gate.leq(f"split_bwd_d{name}_rel_err", _rel(a, b), 2e-2)

    # ---- dropout -------------------------------------------------------
    # the keep fraction of the probe kernel's tile; 131072 Bernoulli draws:
    # sigma(mean) <= 9e-4, bound ~5 sigma
    for rate in (0.1, 0.5):
        mask = tile_keep_mask(PROBE_SEED, **PROBE_TILE, rate=rate, device=device)
        gate.leq(f"dropout_keep_fraction_err_rate{rate}",
                 abs(float(mask.mean()) - (1.0 - rate)), 5e-3)
        plain = tile_keep_mask_reference(PROBE_SEED, **PROBE_TILE, rate=rate, device=device)
        port.true(f"probe_bits_equal_plain_rate{rate}", bool(torch.equal(mask, plain)))

    rate, seed = 0.1, 1234

    def dropped(q, k, v, r=rate, s=seed):
        return _attn(q, k, v, dropout_rate=r, dropout_seed=s, **blocks)

    o1, o2 = dropped(q, k, v), dropped(q, k, v)
    gate.true("dropout_deterministic_given_seed", bool(torch.allclose(o1, o2)))
    o3 = dropped(q, k, v, s=99)
    gate.true("dropout_seed_sensitivity", bool(not torch.allclose(o1, o3)))
    # E[dropout attention] = plain attention; the mean over n seeds converges
    # as 1/sqrt(n); the single-seed deviation is ~0.15 here: bound 3x that
    n_seeds = 4 if quick else 24
    outs = torch.stack([dropped(q, k, v, s=s_) for s_ in range(n_seeds)])
    gate.leq("dropout_mean_convergence", _max_abs(outs.mean(0), ref),
             3 * 0.15 / np.sqrt(n_seeds))
    g = _grads(dropped, q, k, v)
    gate.true("dropout_grad_finite", bool(torch.isfinite(g[0]).all()))

    # the fused backward: deterministic given the seed (forward and backward
    # regenerate the same in-kernel mask), and continuous in the rate
    g1, g2 = _grads(dropped, q, k, v), _grads(dropped, q, k, v)
    dq_spread = _rel(g1[0], g2[0]) if float(g2[0].abs().max()) else 0.0
    # the mask both launches regenerate, one tile of it through the probe
    m1, m2 = (tile_keep_mask(seed, 0, 0, 0, block_q=256, block_k=256, rate=rate,
                             device=device) for _ in range(2))
    parts = {
        "out": bool(torch.equal(o1, o2)),
        "dk": bool(torch.equal(g1[1], g2[1])),
        "dv": bool(torch.equal(g1[2], g2[2])),
        "mask": bool(torch.equal(m1, m2)),
    }
    for part, equal in parts.items():
        port.true(f"fused_bwd_deterministic_{part}_bit_equal", equal)
    port.leq("fused_bwd_dq_atomic_spread_rel", dq_spread, DQ_ATOMIC_REL)
    gate.true("fused_bwd_deterministic_given_seed",
              all(parts.values()) and dq_spread <= DQ_ATOMIC_REL)
    # rate 1e-10 rounds to a zero drop threshold: the FUSED kernel runs (the
    # dropout path is taken) but keeps every element, so it must match the
    # split no-dropout gradient up to the two formulations' rounding
    tiny = 1e-10
    port.true("rate_to_zero_threshold_is_zero", dropout_threshold(tiny) == 0)
    port.true("rate_to_zero_takes_fused_route",
              backward_route(tiny) == (_kernels.FLASH_BWD.name,))
    before = _kernels.FLASH_BWD.launches
    g_tiny = _grads(lambda *a: dropped(*a, r=tiny), q, k, v)
    if device.type == "cuda":
        port.true("rate_to_zero_launched_fused", _kernels.FLASH_BWD.launches == before + 1)
    gate.leq("fused_bwd_rate_to_zero_rel", _rel(g_tiny[0], gf[0]), 2e-2)
    return gate, port


def _cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_shapes(device: torch.device, *, block_q=None, block_k=None) -> dict:
    """Forward, forward + backward at rate 0 and at rate 0.1, in bf16 and
    f32, at :data:`TIMING_SHAPES`: ms (CUDA events, mean of 20 forward or
    10 forward + backward calls after 3) and TFLOP/s by the JAX tool's
    formulas (4 B H S^2 D a forward, 3.5x that a forward + backward)."""
    timing = {}
    blocks = dict(block_q=block_q, block_k=block_k)
    gen = torch.Generator(device=device).manual_seed(0)
    for tag, (B, H, S, D) in TIMING_SHAPES.items():
        flops_fwd = 4 * B * H * S * S * D
        print(f"--- timing {tag}: (B,H,S,D)=({B},{H},{S},{D}) ---")
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            qq, kk, vv = (
                (torch.randn((B, H, S, D), generator=gen, device=device) * 0.3).to(dtype)
                for _ in range(3))

            def fwd():
                with torch.no_grad():
                    _attn(qq, kk, vv, **blocks)

            t = _cuda_ms(fwd, 20)
            timing[f"{tag}_{name}_fwd_ms"] = round(t, 3)
            timing[f"{tag}_{name}_fwd_tflops"] = round(flops_fwd / t / 1e9, 1)
            print(f"[{name}] fwd  {t:7.3f} ms  {flops_fwd / t / 1e9:6.1f} TFLOP/s")
            for label, kw in (("fwdbwd", {}),
                              ("fwdbwd_dropout", dict(dropout_rate=0.1, dropout_seed=1234))):
                leaves = [t_.detach().requires_grad_() for t_ in (qq, kk, vv)]

                def grad():
                    out = _attn(*leaves, **kw, **blocks)
                    torch.autograd.grad(out.sum(), leaves)

                t = _cuda_ms(grad, 10)
                timing[f"{tag}_{name}_{label}_ms"] = round(t, 3)
                timing[f"{tag}_{name}_{label}_tflops"] = round(3.5 * flops_fwd / t / 1e9, 1)
                print(f"[{name}] {label} {t:7.3f} ms  {3.5 * flops_fwd / t / 1e9:6.1f} "
                      "TFLOP/s (fwd+bwd)")
            del qq, kk, vv
    return timing


def run(*, quick: bool = False, device: str = "cuda", block_q=None, block_k=None,
        json_path=None) -> dict:
    """The gate and, on the card without ``quick``, the timing; returns the
    report (``ok`` when every check of both gates holds)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to check the plain twins on the CPU")
    enable_persistent_cache()
    smi = card_line(device)
    print("device:", device, smi, flush=True)
    report: dict = {"device": str(device), "card": smi}
    # the plain attention in full float32 on the card (no TF32 products)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gate, port = check(device, quick=quick, block_q=block_q, block_k=block_k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    report["checks"] = gate.checks
    report["port_checks"] = port.checks
    report["ok"] = gate.ok and port.ok
    if not quick:
        if device.type == "cuda":
            report["timing"] = time_shapes(device, block_q=block_q, block_k=block_k)
            report["timing_card"] = smi
        else:
            print("timing skipped: it times the kernels with CUDA events on the card")
    if json_path:
        Path(json_path).write_text(json.dumps(report, indent=2))
    print("KERNELCHECK", "OK" if report["ok"] else "FAILED", "on", smi)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--block-q", type=int, default=None)
    ap.add_argument("--block-k", type=int, default=None)
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    report = run(quick=args.quick, device=args.device, block_q=args.block_q,
                 block_k=args.block_k, json_path=args.json)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
