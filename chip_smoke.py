#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no final line):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the port's CUDA kernels from ``csrc/``;
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   shapes the serving path gives it, with times;
4. slice: the full-width model (random weights from a seed, BatchNorm folded,
   bf16) decodes 16 raw windows through ``cli.serve.build_decode_fn``; both
   kernels' launch counters must rise;
5. card vs CPU: the same port and weights on one window in float32 on the
   card and on the CPU; the fused encoder features must agree;
6. serving: the decode function behind the runtime's ``BatchScheduler``.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
kernels' JSON summary.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

DEVICE = "cuda"


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
    checks["sosfilt"].append(dict(shape=list(x.shape), dtype="float32", max_abs_err=err,
                                  bound=bound, ms=ms, plain_ms=plain))
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
            name = str(dtype).removeprefix("torch.")
            checks["flash_fwd"].append(dict(
                shape=[64 * heads, 1655, d], dtype=name, max_abs_err=err,
                lse_max_abs_err=lse_err, bound=bound, ms=ms, plain_ms=plain,
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

    from imagined_speech_translation_tpu.config import default_config, replace_nested
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
    missing = [k for k, n in launches.items() if n == 0]
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

    from imagined_speech_translation_tpu.runtime.batcher import BatchScheduler

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


def summary(checks, launches):
    from imagined_speech_translation_tpu_torch import _kernels

    out = []
    for k in _kernels.KERNELS:
        main = checks[k.name][-1] if k.name == "sosfilt" else next(
            c for c in checks[k.name] if c["dtype"] == "bfloat16" and c["shape"][-1] == 128
        )
        out.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=launches[k.name],
            max_abs_err=max(c["max_abs_err"] for c in checks[k.name]),
            ms=main["ms"], plain_ms=main["plain_ms"], checks=checks[k.name],
        ))
    return {"kernels": out}


def main() -> int:
    import torch

    smi = phase_device()
    phase_build()
    checks = phase_kernels()
    decode_fn, launches, ctx = phase_slice(smi)
    phase_card_vs_cpu(ctx)
    phase_serving(decode_fn, ctx["cfg"].data.n_timepoints)
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps(summary(checks, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
