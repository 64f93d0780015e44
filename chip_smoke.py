#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no final line):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with times;
4. train kernels: at the training shapes, the dropout keep-mask probe bit for
   bit, the flash forward with dropout 0.1 (max |err| / max |ref| within
   1e-4 f32 / 1e-2 bf16, a bound that the plain version without the mask or
   with another seed's mask must exceed), and the fused flash backward
   (rates 0 and 0.1) against autograd through the plain version, in float32
   and bfloat16, with times beside ``F.scaled_dot_product_attention``'s;
5. slice: the full-width model (random weights from a seed, BatchNorm folded,
   bf16) decodes 16 raw windows through ``cli.serve.build_decode_fn``; the
   serving kernels' launch counters must rise;
6. card vs CPU: the same port and weights on one window in float32 on the
   card and on the CPU; the fused encoder features must agree;
7. serving: the decode function behind the runtime's ``BatchScheduler``;
8. train: 3 optimizer steps of ``training.make_train_step`` at full width
   (``default_config()``: 8 micro-steps of 4 windows, mixed precision, fused
   AdamW); finite losses, weights still at step 0 (learning rate 0) and
   moved at step 1, and 5 flash forward and 5 flash backward launches per
   micro-step;
9. train card vs CPU: a small float32 configuration's loss and gradients
   (eval-mode forward, dropout off) on the card and on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON summary, with each kernel's launches on the serving and the
training path.  ``dropout_mask`` is a check-only probe: the mask it writes is
the ``__device__`` function every flash launch with dropout evaluates, so
its own launch count is 0 on both paths.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEVICE = "cuda"
SERVING_KERNELS = ("sosfilt", "flash_fwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Published peaks of one H100 SXM (dense): bf16 tensor cores, float32 on the
# CUDA cores, HBM bandwidth.  A kernel's bound is the larger of its FLOPs over
# the peak for its type and its bytes (each input read once, each output
# written once) over the bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """(least milliseconds on the card, what bounds it)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(
        f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}"
    )
    return smi


def phase_build():
    from imagined_speech_translation_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.library()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_kernels.build_seconds:.2f} s)")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[build] {line.strip()}")


def phase_kernels():
    """Each kernel vs its plain twin at serving shapes; returns per-kernel checks."""
    import numpy as np
    import torch

    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch.frontend import (
        SignalFrontend,
        sosfilt,
        sosfilt_reference,
    )
    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checks = {"sosfilt": [], "flash_fwd": []}

    # sosfilt: batch 16 x 125 channels x 1651 samples, float32
    fe = SignalFrontend()
    banks = [fe.sos_bandpass, fe.sos_notch]
    x = torch.from_numpy(rng.normal(size=(16 * 125, 1651)).astype(np.float32)).to(dev)
    got = sosfilt(banks, x)
    ref = sosfilt_reference(banks, x)
    err = (got - ref).abs().max().item()
    bound = 2e-4 * x.abs().max().item()
    ms = cuda_ms(lambda: sosfilt(banks, x))
    plain = cuda_ms(lambda: sosfilt_reference(banks, x), iters=2, warmup=1)
    least, by = least_time(50 * x.numel(), 2 * 4 * x.numel(), "float32")
    checks["sosfilt"].append(dict(shape=list(x.shape), dtype="float32", max_abs_err=err,
                                  bound=bound, ms=ms, plain_ms=plain, library_ms=None,
                                  bound_ms=least, bound_by=by))
    log(f"[kernels] sosfilt {tuple(x.shape)} f32: max|err| {err:.3e} (bound {bound:.3e}) "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    if not err <= bound:
        raise AssertionError(f"sosfilt disagrees with its plain twin: {err} > {bound}")

    # flash forward: (b*h, 1655, d) for the self-attention (d=128, 6 heads)
    # and the shared cross-scale attention (d=256, 3 heads), batch 16 x 4 regions
    for heads, d in ((6, 128), (3, 256)):
        for dtype, bound in ((torch.float32, 5e-4), (torch.bfloat16, 3e-2)):
            shape = (64, heads, 1655, d)
            q, k, v = (
                torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
                .to(dev, dtype) for _ in range(3)
            )
            out, lse = flash_attention(q, k, v)
            ref, ref_lse = flash_attention_reference(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ms = cuda_ms(lambda: flash_attention(q, k, v), iters=5)
            plain = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=5)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5)
            name = str(dtype).removeprefix("torch.")
            least, by = least_time(4 * q.numel() * 1655, 4 * q.numel() * q.element_size(), name)
            checks["flash_fwd"].append(dict(
                shape=[64 * heads, 1655, d], dtype=name, max_abs_err=err,
                lse_max_abs_err=lse_err, bound=bound, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=least, bound_by=by,
            ))
            log(f"[kernels] flash_fwd ({64 * heads}, 1655, {d}) {name}: max|err| "
                f"{err:.3e} (bound {bound:.0e}), lse max|err| {lse_err:.3e}; "
                f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
            if not (err <= bound and lse_err <= bound):
                raise AssertionError(f"flash_fwd disagrees with its plain twin: {err}")
            del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()

    # other head dims (96/192: reference heads (8,4,4)) and ragged lengths,
    # correctness only: both dtypes, both kernel variants (bf16 with d % 16
    # takes the tensor cores, other d the FMA path)
    worst = {}
    for d in (8, 40, 48, 96, 192):
        for dtype, bound in ((torch.float32, 5e-4), (torch.bfloat16, 3e-2)):
            q = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
            kv = torch.from_numpy(rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
            q, k, v = q.to(dev, dtype), kv[0].to(dev, dtype), kv[1].to(dev, dtype)
            out, lse = flash_attention(q, k, v)
            ref, ref_lse = flash_attention_reference(q, k, v)
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            worst[(d, str(dtype).removeprefix("torch."))] = err
            if not err <= bound:
                raise AssertionError(f"flash_fwd d={d} {dtype}: {err} > {bound}")
    log(f"[kernels] flash_fwd (6, 200 x 333, d) max|err| by (d, dtype): "
        + ", ".join(f"{k}: {v:.1e}" for k, v in worst.items()))
    # a head dim that is not a multiple of 8 is refused, not run
    q = torch.zeros((1, 1, 128, 100), device=dev)
    try:
        flash_attention(q, q, q)
    except ValueError as e:
        log(f"[kernels] flash_fwd d=100 refused: {e}")
    else:
        raise AssertionError("flash_fwd accepted head dim 100")
    return checks


def phase_train_kernels():
    """The training path's kernels against their plain twins at its shapes
    (micro-batch 4 x 4 regions: (96, 1655, 128) self-attention and
    (48, 1655, 256) cross-scale attention): the keep-mask probe bit for bit,
    the forward with dropout 0.1, and the fused backward at rates 0 and 0.1
    against autograd through the plain version.  Times: kernel, plain, and
    ``F.scaled_dot_product_attention`` with the same dropout rate (a
    yardstick only; the port never calls it)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from imagined_speech_translation_tpu_torch.ops import (
        flash_attention,
        flash_attention_reference,
        tile_keep_mask,
    )
    from imagined_speech_translation_tpu_torch.ops.dropout_mask import (
        dropout_blocks,
        tile_keep_mask_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    rate, seed, S = 0.1, 1234, 1655
    checks = {"dropout_mask": [], "flash_fwd": [], "flash_bwd": []}

    # keep-mask probe: every logical tile of heads 0-3 and 95, both tilings
    for dtype in (torch.bfloat16, torch.float32):
        bq, bk = dropout_blocks(96, S, S, dtype)
        tiles = [(bh, qi, ki) for bh in (0, 1, 2, 3, 95)
                 for qi in range(-(-S // bq)) for ki in range(-(-S // bk))]
        kept = torch.zeros((), dtype=torch.float64, device=dev)
        mismatches = torch.zeros((), dtype=torch.int64, device=dev)
        for bh, qi, ki in tiles:
            got = tile_keep_mask(seed, bh, qi, ki, block_q=bq, block_k=bk, rate=rate, device=dev)
            want = tile_keep_mask_reference(seed, bh, qi, ki, block_q=bq, block_k=bk, rate=rate,
                                            device=dev)
            mismatches += (got != want).sum()
            kept += got.sum(dtype=torch.float64)
        frac = kept.item() / (len(tiles) * bq * bk)
        n_bad = int(mismatches.item())
        args = (seed, 3, 1, 2)
        kw = dict(block_q=bq, block_k=bk, rate=rate)
        ms = cuda_ms(lambda: tile_keep_mask(*args, **kw, device=dev), iters=50)
        plain = cuda_ms(lambda: tile_keep_mask_reference(*args, **kw, device=dev), iters=20)
        name = str(dtype).removeprefix("torch.")
        least, by = least_time(12 * bq * bk, 4 * bq * bk, "float32")  # ~12 integer ops each
        checks["dropout_mask"].append(dict(
            tile=[bq, bk], storage=name, tiles=len(tiles), mismatches=n_bad,
            keep_fraction=frac, max_abs_err=float(n_bad > 0), ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=least, bound_by=by,
        ))
        log(f"[train-kernels] dropout_mask ({bq}, {bk}) x {len(tiles)} tiles: {n_bad} "
            f"mismatches, keep fraction {frac:.6f} (0.9 +- 1e-3); probe {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
        if n_bad or not abs(frac - 0.9) <= 1e-3:
            raise AssertionError(f"dropout_mask probe: {n_bad} mismatches, keep {frac}")

    # forward with dropout: out against the plain version on the same input
    # values in float32 (the dtype's own logical tiles), max |err| / max |ref|
    # within fwd_rel; the same measure against the plain version without
    # the mask, and with the next seed's mask, must exceed fwd_rel, so the
    # bound tells a right mask from a missing or wrong one.  Out and lse are
    # also held to the serving phase's absolute bounds.
    for heads, d in ((6, 128), (3, 256)):
        shape = (16, heads, S, d)
        bh = 16 * heads
        for dtype, fwd_bound, fwd_rel, bwd_bound in ((torch.float32, 5e-4, 1e-4, 1e-4),
                                                     (torch.bfloat16, 3e-2, 1e-2, 3e-2)):
            name = str(dtype).removeprefix("torch.")
            q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3)
                       .to(dev, dtype) for _ in range(3))
            dout = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)
            kw = dict(dropout_rate=rate, dropout_seed=seed)
            out, lse = flash_attention(q, k, v, **kw)
            out = out.float()
            tiles = dict(zip(("block_q", "block_k"), dropout_blocks(bh, S, S, dtype)))
            qf, kf, vf = q.float(), k.float(), v.float()
            ref, ref_lse = flash_attention_reference(qf, kf, vf, **kw, **tiles)
            top = ref.abs().max().item()
            err = (out - ref).abs().max().item()
            rel = err / top
            lse_err = (lse - ref_lse).abs().max().item()
            del ref, ref_lse
            wrong = []
            for r, s in ((0.0, seed), (rate, seed + 1)):
                other = flash_attention_reference(qf, kf, vf, dropout_rate=r, dropout_seed=s,
                                                  **tiles)[0]
                wrong.append((out - other).abs().max().item() / top)
                del other
            del out, lse, qf, kf, vf
            ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters=5)
            plain = cuda_ms(lambda: flash_attention_reference(q, k, v, **kw), iters=3)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, dropout_p=rate),
                          iters=5)
            flops = 4 * bh * S * S * d
            io = q.numel() * q.element_size()  # bytes of one (bh, S, d) tensor
            least, by = least_time(flops, 4 * io + 4 * bh * S, name)
            checks["flash_fwd"].append(dict(
                shape=[bh, S, d], dtype=name, dropout=rate, max_abs_err=err,
                lse_max_abs_err=lse_err, bound=fwd_bound, rel_err=rel, rel_bound=fwd_rel,
                rel_err_vs_no_mask=wrong[0], rel_err_vs_next_seed=wrong[1], ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=least, bound_by=by,
            ))
            log(f"[train-kernels] flash_fwd ({bh}, {S}, {d}) {name} dropout {rate}: max|err| "
                f"{err:.3e} (max|ref| {top:.3e}), lse {lse_err:.3e} (bound {fwd_bound:.0e}); "
                f"max|err|/max|ref| {rel:.2e} (bound {fwd_rel:.0e}), against no mask "
                f"{wrong[0]:.2e} and the next seed's {wrong[1]:.2e} (must exceed it); "
                f"kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa {lib:.3f} ms")
            if not (err <= fwd_bound and lse_err <= fwd_bound and rel <= fwd_rel):
                raise AssertionError(f"flash_fwd with dropout disagrees with its twin: {rel}")
            if not min(wrong) > fwd_rel:
                raise AssertionError(f"flash_fwd check cannot tell a missing or wrong mask "
                                     f"from the right one: {wrong} <= {fwd_rel}")

            # backward at rate 0 and rate 0.1; the rate-0.1 gradients must
            # also differ from the rate-0 ones by more than the bound
            dropfree = None
            for r in (0.0, rate):
                kw = dict(dropout_rate=r, dropout_seed=seed)
                qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                out = flash_attention(qg, kg, vg, **kw)[0]
                got = torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)
                ref = flash_attention_reference(qg, kg, vg, **kw)[0]
                want = torch.autograd.grad(ref, (qg, kg, vg), dout, retain_graph=True)
                errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
                rel = [e / b.float().abs().max().item() for e, b in zip(errs, want)]
                apart = None
                if r == 0.0:
                    dropfree = want
                else:
                    apart = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                             for a, b in zip(got, dropfree)]
                    dropfree = None
                del got, want
                ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                                         retain_graph=True), iters=5)
                plain = cuda_ms(lambda: torch.autograd.grad(ref, (qg, kg, vg), dout,
                                                            retain_graph=True), iters=3)
                del ref
                sdpa = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=r)
                lib = cuda_ms(lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dout,
                                                          retain_graph=True), iters=5)
                del out, sdpa
                # reads q, k, v, dO, lse, delta; writes dQ, dK, dV
                least, by = least_time(2.5 * flops, 7 * io + 8 * bh * S, name)
                checks["flash_bwd"].append(dict(
                    shape=[bh, S, d], dtype=name, dropout=r, max_abs_err=max(errs),
                    rel_err_dq_dk_dv=rel, bound=bwd_bound, rel_err_vs_no_mask=apart, ms=ms,
                    plain_ms=plain, library_ms=lib, bound_ms=least, bound_by=by,
                ))
                log(f"[train-kernels] flash_bwd ({bh}, {S}, {d}) {name} dropout {r}: "
                    f"max|err|/max|ref| dq {rel[0]:.2e} dk {rel[1]:.2e} dv {rel[2]:.2e} "
                    f"(bound {bwd_bound:.0e})"
                    + ("" if apart is None else ", against the rate-0 gradients " + " ".join(
                        f"{a:.2e}" for a in apart) + " (must exceed it)")
                    + f"; kernel {ms:.3f} ms, plain {plain:.3f} ms, sdpa bwd {lib:.3f} ms")
                if not max(rel) <= bwd_bound:
                    raise AssertionError(f"flash_bwd disagrees with autograd of its twin: {rel}")
                if apart is not None and not min(apart) > bwd_bound:
                    raise AssertionError(f"flash_bwd check cannot tell the mask's gradients "
                                         f"from the rate-0 ones: {apart} <= {bwd_bound}")
            del q, k, v, dout
            torch.cuda.empty_cache()

    # other head dims (96/192: reference heads (8,4,4)) and ragged lengths,
    # correctness only: both dtypes and both backward variants (bf16 with
    # d % 16 == 0 takes the tensor cores, other d the CUDA cores)
    worst = {}
    for d in (8, 40, 48, 96, 192):
        for dtype, bwd_bound in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
            q = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32) * 0.3)
            kv = torch.from_numpy(rng.normal(size=(2, 2, 3, 333, d)).astype(np.float32) * 0.3)
            dout = torch.from_numpy(rng.normal(size=(2, 3, 200, d)).astype(np.float32))
            q, k, v = (t.to(dev, dtype).requires_grad_() for t in (q, kv[0], kv[1]))
            dout = dout.to(dev, dtype)
            kw = dict(dropout_rate=rate, dropout_seed=seed, block_q=128, block_k=128)
            got = torch.autograd.grad(flash_attention(q, k, v, **kw)[0], (q, k, v), dout)
            want = torch.autograd.grad(flash_attention_reference(q, k, v, **kw)[0], (q, k, v),
                                       dout)
            rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(got, want))
            worst[(d, str(dtype).removeprefix("torch."))] = rel
            if not rel <= bwd_bound:
                raise AssertionError(f"flash_bwd d={d} {dtype}: {rel} > {bwd_bound}")
    log("[train-kernels] flash_bwd (6, 200 x 333, d) dropout 0.1 max|err|/max|ref| by "
        "(d, dtype): " + ", ".join(f"{k}: {v:.1e}" for k, v in worst.items()))
    return checks


def recording_tokenizer(vocab):
    """The port's tokenizer, keeping the ids of the last ``batch_decode``."""
    from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer

    class Recording(ChineseCharTokenizer):
        def batch_decode(self, batch_ids, **kw):
            self.ids = batch_ids
            return super().batch_decode(batch_ids, **kw)

    return Recording(vocab)


def phase_slice(smi: str):
    """Full-width serving slice: 16 raw windows -> text, BN folded, bf16."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli.profile_slice import (
        synthetic_montage,
        synthetic_vocab,
    )
    from imagined_speech_translation_tpu_torch.cli.serve import build_decode_fn
    from imagined_speech_translation_tpu_torch.data import RegionSpec
    from imagined_speech_translation_tpu_torch.models import build_model

    cfg = default_config()
    # pinned decode length (min == max): every window decodes all 16 tokens
    cfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    T = cfg.data.n_timepoints
    tok = recording_tokenizer(synthetic_vocab(cfg.model.bart.vocab_size))
    spec = RegionSpec.from_channel_names(synthetic_montage())
    t0 = time.perf_counter()
    model = build_model(cfg.model, T, seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[slice] model: {n_params / 1e6:.1f}M params, random from seed 0, "
        f"built in {time.perf_counter() - t0:.1f} s")
    decode_fn = build_decode_fn(cfg, tok, spec, model, device=DEVICE, fold_bn=True,
                                compute_dtype=torch.bfloat16)
    windows = np.random.default_rng(1).normal(size=(16, 125, T)).astype(np.float32)
    t0 = time.perf_counter()
    decode_fn(windows)
    log(f"[slice] first batch (warm-up) {time.perf_counter() - t0:.2f} s")

    _kernels.reset_launch_counts()
    texts = decode_fn(windows)
    launches = _kernels.launch_counts()
    log(f"[slice] kernel launches in one batch: {launches}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the serving path launched no {missing} kernel")
    ids = np.asarray(tok.ids)
    if len(texts) != 16 or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"expected 16 strings, got {texts!r}")
    if ids.shape != (16, cfg.generation.max_length) or ids.min() < 0 or (
        ids.max() >= cfg.model.bart.vocab_size
    ):
        raise AssertionError(f"tokens out of shape/range: {ids.shape} [{ids.min()}, {ids.max()}]")
    log(f"[slice] window 0 -> {texts[0][:40]!r}")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_fn(windows)
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    log(f"[slice] B=16 T={T} beam {cfg.generation.num_beams} pinned length "
        f"{cfg.generation.max_length}, bf16, BN folded: {sec:.4f} s/batch (median of 5, "
        f"all {[round(t, 4) for t in times]}), {16 / sec:.2f} windows/s on {smi}")
    return decode_fn, launches, dict(cfg=cfg, tok=tok, spec=spec, model=model)


def phase_card_vs_cpu(ctx):
    """One window, float32, BN unfolded, TF32 off: the same port and weights
    on the card and on the CPU."""
    import copy

    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch.cli.serve import build_decode_fn
    from imagined_speech_translation_tpu_torch.frontend import SignalFrontend

    cfg, tok, spec, model = ctx["cfg"], ctx["tok"], ctx["spec"], ctx["model"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = cfg.data.n_timepoints
    window = np.random.default_rng(2).normal(size=(1, 125, T)).astype(np.float32)
    models = {DEVICE: model, "cpu": copy.deepcopy(model).cpu()}
    frontend = SignalFrontend(cfg.frontend)
    R, C = spec.channel_mask.shape
    feats, ids = {}, {}
    for dev, m in models.items():
        t0 = time.perf_counter()
        with torch.inference_mode():
            clean = frontend.preprocess(torch.from_numpy(window).to(dev))
            stacked = clean[:, torch.as_tensor(spec.gather_indices.reshape(-1), device=dev)]
            mask = torch.as_tensor(spec.channel_mask, device=dev)
            feat, _ = m.encode(stacked.reshape(1, R, C, T), mask)
        feats[dev] = feat.float().cpu()
        build_decode_fn(cfg, tok, spec, m, device=dev, fold_bn=False)(window)
        ids[dev] = np.asarray(tok.ids)
        log(f"[card-vs-cpu] {dev}: encode + decode in {time.perf_counter() - t0:.2f} s")
    rel = ((feats[DEVICE] - feats["cpu"]).abs().max() / feats["cpu"].abs().max()).item()
    same = bool((ids[DEVICE] == ids["cpu"]).all())
    log(f"[card-vs-cpu] fused encoder feature max rel err {rel:.3e} (bound 1e-3); "
        f"tokens {'agree' if same else 'differ'}: card {ids[DEVICE][0].tolist()} "
        f"cpu {ids['cpu'][0].tolist()}")
    if not rel <= 1e-3:
        raise AssertionError(f"card and CPU encoder features disagree: {rel}")
    return rel, same


def phase_serving(decode_fn, n_timepoints: int):
    """The decode function behind the runtime's batch scheduler."""
    import asyncio

    import numpy as np

    from imagined_speech_translation_tpu_torch.runtime import BatchScheduler

    windows = np.random.default_rng(3).normal(size=(20, 125, n_timepoints)).astype(np.float32)

    async def run():
        async with BatchScheduler(decode_fn, max_batch=16, max_delay_ms=25) as sched:
            texts = await asyncio.gather(*(sched.submit(w) for w in windows))
        return texts, sched.stats()

    texts, stats = asyncio.run(run())
    if len(texts) != len(windows) or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"scheduler answered {len(texts)} of {len(windows)}")
    log(f"[serving] {len(texts)}/{len(windows)} windows answered; stats {stats}")
    return stats


def phase_train(smi: str):
    """Full-width training: ``default_config()`` (mixed precision, bf16
    accumulation carry, fused AdamW with bf16 first moment, composite loss),
    random weights from seed 0, 3 optimizer steps of ``make_train_step``
    over synthetic windows (8 micro-steps of 4 windows, T = 1651, labels of
    16 tokens).  The default warmup starts at learning rate 0, so step 0
    must leave the weights as they were and step 1 must move them."""
    import numpy as np
    import torch

    from imagined_speech_translation_tpu_torch import _kernels
    from imagined_speech_translation_tpu_torch.cli.profile_slice import (
        synthetic_train_batch,
        synthetic_vocab,
    )
    from imagined_speech_translation_tpu_torch.config import default_config
    from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer
    from imagined_speech_translation_tpu_torch.training import (
        AdaptiveLossScheduler,
        FusedAdamW,
        build_train_module,
        create_train_state,
        get_top_k_vocab_indices,
        make_train_step,
    )

    cfg = default_config()
    tc = cfg.training
    accum, micro, n_steps = tc.grad_accum_steps, tc.batch_size, 3
    tok = ChineseCharTokenizer(synthetic_vocab(cfg.model.bart.vocab_size))
    bow = get_top_k_vocab_indices(tok, tc.loss.bow_vocab_size)
    t0 = time.perf_counter()
    module = build_train_module(cfg, len(bow), seed=0, device=DEVICE)
    n_params = sum(p.numel() for p in module.parameters())
    names = [n for n, _ in module.named_parameters()]
    opt = FusedAdamW(names, tc.optimizer, total_steps=n_steps)
    state = create_train_state(module, opt, AdaptiveLossScheduler(tc.loss).initial_weights())
    step_fn = make_train_step(module, opt, cfg, bow)
    log(f"[train] model + loss heads: {n_params / 1e6:.1f}M params, random from seed 0, "
        f"built in {time.perf_counter() - t0:.1f} s; mixed precision {tc.mixed_precision}, "
        f"carry {tc.grad_accum_dtype}, mu {tc.optimizer.mu_dtype}, accum {accum} x {micro}")
    probe = dict(module.named_parameters())["model.brain_encoder.region_encoders.attn0.q_proj.weight"]
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    times = []
    for i in range(n_steps):
        batch = {k: v.to(DEVICE) for k, v in
                 synthetic_train_batch(cfg, accum, micro, cfg.data.max_length, 100 + i).items()}
        before = probe.detach().clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, torch.Generator().manual_seed(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in metrics.items()}
        moved = (probe.detach() - before).abs().max().item()
        log(f"[train] step {i}: loss {m['loss']:.4f} (ce {m['loss_ce']:.4f}, align "
            f"{m['loss_align']:.4f}, bow {m['loss_bow']:.4f}, div {m['loss_div']:.4f}, var "
            f"{m['loss_var']:.4f}), grad norm {m['grad_norm']:.4f}, max |dW| of attn0.q_proj "
            f"{moved:.3e}, {times[-1]:.3f} s")
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
        if (i == 0) != (moved == 0.0):
            raise AssertionError(f"train step {i} (lr {'0' if i == 0 else '> 0'}) moved the "
                                 f"weights by {moved}")
    launches = _kernels.launch_counts()
    want = 5 * accum * n_steps  # 3 self + 2 cross-scale attentions per micro-step
    log(f"[train] kernel launches in {n_steps} steps: {launches} (flash fwd/bwd want {want})")
    if launches["flash_fwd"] != want or launches["flash_bwd"] != want:
        raise AssertionError(f"training launched flash {launches}, want {want} each")
    sec = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] {sec:.3f} s/step (mean of steps 1-{n_steps - 1}; all "
        f"{[round(t, 3) for t in times]}), {accum * micro / sec:.2f} windows/s, peak memory "
        f"{peak:.1f} GiB, on {smi}")
    del state, step_fn, module, opt
    torch.cuda.empty_cache()
    return launches


def phase_train_card_vs_cpu():
    """The loss function's eval-mode forward (dropout off) and its gradients
    on a small float32 configuration, on the card and on the CPU, from the
    same weights and batch; TF32 off.  T = 252, so the region encoders'
    256-token attentions go through the flash kernels on the card."""
    import copy

    import torch

    from imagined_speech_translation_tpu_torch.cli.profile_slice import synthetic_train_batch
    from imagined_speech_translation_tpu_torch.config import default_config, replace_nested
    from imagined_speech_translation_tpu_torch.training import (
        AdaptiveLossScheduler,
        build_train_module,
        make_loss_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    for path, value in (
        ("data.n_timepoints", 252), ("model.hidden_dim", 64),
        ("model.brain_encoder.hidden_dim", 64), ("model.brain_encoder.fusion_heads", 4),
        ("model.brain_encoder.cross_region_heads", 4),
        ("model.brain_encoder.region_encoder.conv_channels", (16, 16, 32, 32, 64)),
        ("model.brain_encoder.region_encoder.attn_heads", (2, 2, 2)),
        ("model.bart.d_model", 64), ("model.bart.decoder_layers", 2),
        ("model.bart.num_heads", 4), ("model.bart.ffn_dim", 128),
        ("model.bart.vocab_size", 1000), ("training.mixed_precision", False),
        ("training.loss.bow_vocab_size", 16),
    ):
        cfg = replace_nested(cfg, path, value)
    bow = list(range(110, 126))
    module = build_train_module(cfg, len(bow), seed=5, device="cpu")
    batch = {k: v if k == "channel_mask" else v[0]
             for k, v in synthetic_train_batch(cfg, 1, 4, 16, 7).items()}
    weights = AdaptiveLossScheduler(cfg.training.loss).initial_weights()
    out = {}
    for dev, m in (("cpu", module), (DEVICE, copy.deepcopy(module).to(DEVICE))):
        params = dict(m.named_parameters())
        total, comps = make_loss_fn(m, cfg, bow)(
            params, {k: v.to(dev) for k, v in batch.items()}, None, weights)
        grads = torch.autograd.grad(total, list(params.values()))
        out[dev] = (torch.stack([total] + list(comps.values())).detach().cpu(),
                    torch.cat([g.flatten() for g in grads]).cpu())
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[DEVICE]
    loss_rel = ((l_card - l_cpu).abs() / l_cpu.abs()).max().item()
    grad_rel = (torch.linalg.vector_norm(g_card - g_cpu) / torch.linalg.vector_norm(g_cpu)).item()
    n = sum(p.numel() for p in module.parameters())
    log(f"[train-card-vs-cpu] {n / 1e6:.2f}M params f32: loss and components max rel err "
        f"{loss_rel:.3e}, gradient rel err (L2 over all) {grad_rel:.3e} (bound 1e-3 each)")
    if not (loss_rel <= 1e-3 and grad_rel <= 1e-3):
        raise AssertionError(f"train card vs CPU: loss {loss_rel}, grads {grad_rel}")
    return loss_rel, grad_rel


# the check whose numbers head each kernel's entry: the shape and dtype the
# path runs most (serving flash forward at B=16, training backward at
# micro-batch 4 with dropout, the probe's bf16 tile)
HEADLINE = {
    "sosfilt": lambda c: True,
    "flash_fwd": lambda c: c["dtype"] == "bfloat16" and c["shape"] == [384, 1655, 128],
    "flash_bwd": lambda c: (c["dtype"] == "bfloat16" and c["shape"] == [96, 1655, 128]
                            and c["dropout"] > 0),
    "dropout_mask": lambda c: c["storage"] == "bfloat16",
}


def summary(checks, launches_by_path):
    from imagined_speech_translation_tpu_torch import _kernels

    out = []
    for k in _kernels.KERNELS:
        main = next(c for c in checks[k.name] if HEADLINE[k.name](c))
        by_path = {path: n[k.name] for path, n in launches_by_path.items()}
        out.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in checks[k.name]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"], checks=checks[k.name],
        ))
    return {"kernels": out}


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    checks = phase_kernels()
    for name, rows in phase_train_kernels().items():
        checks.setdefault(name, []).extend(rows)
    decode_fn, serve_launches, ctx = phase_slice(smi)
    phase_card_vs_cpu(ctx)
    phase_serving(decode_fn, ctx["cfg"].data.n_timepoints)
    del decode_fn, ctx
    torch.cuda.empty_cache()
    train_launches = phase_train(smi)
    phase_train_card_vs_cpu()
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps(summary(checks, {"serving": serve_launches, "training": train_launches})))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
