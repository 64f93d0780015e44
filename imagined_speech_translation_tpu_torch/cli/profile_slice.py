"""Where the time of one full-width serving batch, or of one training step,
goes on one CUDA card.

    python -m imagined_speech_translation_tpu_torch.cli.profile_slice \
        [--what serve|train] [--compute-dtype bfloat16|float32] [--trace DIR]

``--what serve`` (the default) builds the serving path as ``chip_smoke.py``
times it: ``default_config()``, random weights from seed 0, BatchNorm
folded, 16 raw windows of 125 channels, beam 3, decode length pinned to 16,
in ``--compute-dtype`` (bfloat16 by default; float32 is what the serve
CLIs run when they are given no dtype).  It prints seconds per batch
through ``build_decode_fn`` and through the encoder alone (median of 5
after one warm-up; host clock around synchronized calls, :func:`segment_ms`).

``--what train`` builds the default training step as ``chip_smoke.py`` runs
it: ``default_config()`` with its composite loss and fused AdamW, random
weights from seed 0, one synthetic window batch of 8 micro-steps x 4
windows at T = 1651 (labels of 16 tokens); mixed precision (bf16) by
default, or with ``--compute-dtype float32`` the step with
``training.mixed_precision=False``, the reference's own numerics.  It
prints seconds per optimizer step (median of 3 after one warm-up),
windows/s and peak device memory.

Then one batch (or step) runs under ``torch.profiler`` (:func:`traced_run`):
traced span (first host or device event to last), kernel launches, device
busy time (kernel and copy intervals merged), the idle share of the span
and of the unprofiled median, and device time per kernel name, largest
first.  Its Chrome trace is written to ``<--trace>/trace.json``.  The
card's name and power limit (``nvidia-smi``) head the output.

The segment profilers (``cli.train_profile``, ``train_bench``,
``encoder_profile``, ``beam_profile``, ``decode_profile``) and
``cli.profile`` time their programs with the helpers here:
:func:`time_program` (:func:`segment_ms`, the median wall time between
synchronizes, and :func:`profiled_run`, the device busy time and launches
of one traced run and the port's kernel launches by name),
:func:`traced_run`, :func:`roundtrip_ms`, :func:`open_device` and
:func:`card_line`.  Every trace goes through ``utils.profiling.trace``,
which refuses one that lost device records.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..config import default_config, replace_nested
from ..data import ChineseCharTokenizer, RegionSpec
from ..data.regions import ELECTRODE_REGIONS
from ..frontend import SignalFrontend
from ..models import build_model, fold_batch_norm
from ..training import (
    AdaptiveLossScheduler,
    FusedAdamW,
    build_train_module,
    create_train_state,
    get_top_k_vocab_indices,
    make_train_step,
)
from ..utils.cache import enable_persistent_cache
from ..utils.profiling import IncompleteTrace, trace
from .serve import build_decode_fn

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def synthetic_vocab(size: int) -> list[str]:
    """A BERT-layout vocab of ``size`` tokens: the special ids the decoder
    uses, then CJK characters, then plain word pieces."""
    special = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    rest = [chr(0x4E00 + i) if i < 0x5200 else f"w{i}" for i in range(size - len(special))]
    return special + rest


def synthetic_montage(n_channels: int = 125) -> list[str]:
    """``n_channels`` labels with the 48 region electrodes scattered among
    auxiliary channels, as in a real montage."""
    labels = [f"AUX{i}" for i in range(n_channels)]
    mapped = [ch for region in ELECTRODE_REGIONS.values() for ch in region]
    slots = sorted(np.random.default_rng(0).choice(n_channels, size=len(mapped), replace=False))
    for slot, ch in zip(slots, mapped):
        labels[slot] = ch
    return labels


def synthetic_train_batch(cfg, accum: int, batch: int, length: int, seed: int):
    """A window batch ``(accum, batch, ...)`` made with numpy: EEG at
    ``cfg.data.n_timepoints`` on the padded region channels, decoder inputs
    and next-token labels over the vocabulary's content ids, the second
    window's labels padded with -100 after 12 tokens."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((len(cfg.model.region_channel_counts), cfg.model.max_region_channels), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    eeg = rng.normal(size=(accum, batch) + mask.shape + (cfg.data.n_timepoints,))
    ids = rng.integers(105, cfg.model.bart.vocab_size, (accum, batch, length + 1))
    attn = np.ones((accum, batch, length), np.int32)
    labels = ids[..., 1:].copy()
    attn[:, 1, 12:] = 0
    labels[:, 1, 12:] = -100
    arrays = dict(eeg=(eeg * mask[..., None]).astype(np.float32),
                  decoder_input_ids=ids[..., :-1], labels=labels, attention_mask=attn,
                  channel_mask=mask)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


def device_summary(trace_events: list[dict]) -> dict:
    """Span, device busy time and per-kernel time from Chrome-trace events.

    ``span_ms`` runs from the first event's start to the last event's end;
    ``busy_ms`` is the union of the device intervals (kernels, copies,
    memsets), so overlapping streams are not counted twice."""
    spans = [e for e in trace_events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise RuntimeError("the trace holds no device activity: the profiler saw no kernel")
    start = min(e["ts"] for e in spans)
    span = max(e["ts"] + e["dur"] for e in spans) - start
    busy, end = 0.0, -float("inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    per_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        per_name[e["name"]][0] += e["dur"]
        per_name[e["name"]][1] += 1
    return dict(
        span_ms=span / 1e3, busy_ms=busy / 1e3, idle_share=1.0 - busy / span,
        launches=sum(e.get("cat") == "kernel" for e in device),
        by_name=sorted(((n, t / 1e3, c) for n, (t, c) in per_name.items()),
                       key=lambda r: -r[1]),
    )


def traced_run(fn, log_dir, *, after=None, attempts: int = 3) -> Path:
    """Run ``fn()`` under ``utils.profiling.trace`` into ``log_dir`` and
    return the trace's path.  A trace that lost device records
    (``IncompleteTrace``) is taken again, up to ``attempts`` runs in all, and
    the last refusal raises; ``after()`` (a restore of the state ``fn``
    changed) runs after every run."""
    for attempt in range(1, attempts + 1):
        try:
            with trace(log_dir) as path:
                fn()
            return path
        except IncompleteTrace as e:
            if attempt == attempts:
                raise
            print(f"traced run {attempt} of {attempts} refused ({e}); tracing again", flush=True)
        finally:
            if after is not None:
                after()


def print_profile(fn, log_dir: Path, unprofiled_s: float) -> None:
    """Run ``fn`` once under ``torch.profiler`` (:func:`traced_run`) and print
    its device summary."""
    path = traced_run(fn, log_dir)
    s = device_summary(json.loads(path.read_text())["traceEvents"])
    print(f"traced span {s['span_ms']:.1f} ms, {s['launches']} kernel launches, device busy "
          f"{s['busy_ms']:.1f} ms, idle share {s['idle_share']:.3f} in the trace, "
          f"{1 - s['busy_ms'] / (unprofiled_s * 1e3):.3f} of the unprofiled run (trace: {path})")
    for name, ms, count in s["by_name"][:20]:
        print(f"  {ms:9.3f} ms  n={count:5d}  {name[:90]}")


def profile_train(dev: torch.device, trace_dir: Path, mixed_precision: bool = True) -> None:
    cfg = replace_nested(default_config(), "training.mixed_precision", mixed_precision)
    tc = cfg.training
    tok = ChineseCharTokenizer(synthetic_vocab(cfg.model.bart.vocab_size))
    bow = get_top_k_vocab_indices(tok, tc.loss.bow_vocab_size)
    module = build_train_module(cfg, len(bow), seed=0, device=dev)
    opt = FusedAdamW([n for n, _ in module.named_parameters()], tc.optimizer, total_steps=10)
    state = create_train_state(module, opt, AdaptiveLossScheduler(tc.loss).initial_weights())
    step_fn = make_train_step(module, opt, cfg, bow)
    batch = {k: v.to(dev) for k, v in synthetic_train_batch(
        cfg, tc.grad_accum_steps, tc.batch_size, cfg.data.max_length, 100).items()}
    step = lambda: step_fn(state, batch, torch.Generator().manual_seed(state.step))  # noqa: E731
    torch.cuda.reset_peak_memory_stats(dev)
    step_s = segment_ms(step, dev, 3) / 1e3
    windows = tc.grad_accum_steps * tc.batch_size
    print(f"train step ({'bfloat16 mixed precision' if mixed_precision else 'float32'}) "
          f"{step_s:.4f} s (median of 3 after a warm-up), "
          f"{windows / step_s:.2f} windows/s, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB", flush=True)
    print_profile(step, trace_dir, step_s)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them; ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def open_device(name: str) -> tuple[torch.device, str]:
    """A segment profiler's ``--device``: the device and its
    :func:`card_line`, printed first.  ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    enable_persistent_cache()
    smi = card_line(device)
    print(smi, flush=True)
    return device, smi


def channel_mask(cfg, device=None) -> torch.Tensor:
    """The ``(R, C)`` mask of ``cfg``'s regions' real channels."""
    mask = np.zeros((len(cfg.model.region_channel_counts), cfg.model.max_region_channels), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    return torch.as_tensor(mask, device=device)


def segment_ms(fn, device: torch.device, iters: int, *, after=None) -> float:
    """Median wall milliseconds of ``fn()`` over ``iters`` runs after one
    warm-up, each timed on the host clock from a synchronize of ``device`` to
    the next; ``after()`` (a restore of the state ``fn`` changed) runs
    untimed after every run."""
    times = []
    for i in range(iters + 1):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after()
    return float(np.median(times))


def roundtrip_ms(device: torch.device, iters: int) -> float:
    """The measured cost of an empty synchronize (nothing enqueued)."""
    return segment_ms(lambda: None, device, iters)


def profiled_run(fn, device: torch.device, *, after=None) -> dict:
    """One run of ``fn``: the port's kernel launches by name (the wrappers'
    counts) and, on a card, the device busy milliseconds and kernel launches
    of its trace (:func:`traced_run`, which takes a trace again if it lost
    device records, and :func:`device_summary`); ``None`` on the CPU, which
    has no device trace.  ``after()`` runs after every run."""
    from .. import _kernels

    counts = {}

    def counted():
        before = _kernels.launch_counts()
        fn()
        sync(device)
        now = _kernels.launch_counts()
        counts.update({k: now[k] - before[k] for k in now})

    if device.type != "cuda":
        counted()
        if after is not None:
            after()
        return dict(device_ms=None, launches=None, kernel_launches=counts)
    with tempfile.TemporaryDirectory() as tmp:
        path = traced_run(counted, tmp, after=after)
        s = device_summary(json.loads(path.read_text())["traceEvents"])
    return dict(device_ms=s["busy_ms"], launches=s["launches"], kernel_launches=counts)


def time_program(name: str, fn, device: torch.device, iters: int, *, after=None):
    """``(wall ms, profiled run)`` of one program: :func:`segment_ms`, then
    :func:`profiled_run`, printed as one line."""
    ms = segment_ms(fn, device, iters, after=after)
    prof = profiled_run(fn, device, after=after)
    print(f"{name}: {ms:.3f} ms (device {prof['device_ms']} ms, {prof['launches']} launches)",
          flush=True)
    return ms, prof


def by_program(profs: dict) -> dict:
    """``{program: profiled run}`` -> the report's ``device_ms``,
    ``launches`` and ``kernel_launches``, each by program."""
    return {key: {name: prof[key] for name, prof in profs.items()}
            for key in ("device_ms", "launches", "kernel_launches")}


def peak_memory_gib(device: torch.device) -> float | None:
    """Peak device memory since the last reset, GiB; ``None`` on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def write_report(report: dict, path: Path) -> None:
    """Print ``report`` as JSON and write it to ``path``."""
    text = json.dumps(report, indent=2)
    print(text, flush=True)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", choices=("serve", "train"), default="serve",
                    help="a serving batch or a training step")
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the compute dtype of the serving batch (--what serve) or of the "
                    "training step (--what train: float32 turns mixed precision off)")
    ap.add_argument("--trace", default=None,
                    help="the directory of the Chrome trace trace.json (build/profile/<what>)")
    args = ap.parse_args(argv)
    trace_dir = Path(args.trace or f"build/profile/{args.what}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    smi = card_line(torch.device("cuda"))
    print(smi, flush=True)
    if args.what == "train":
        profile_train(torch.device("cuda"), trace_dir,
                      mixed_precision=args.compute_dtype == "bfloat16")
        print(smi, flush=True)
        return 0

    cfg = default_config()
    cfg = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    T, dev = cfg.data.n_timepoints, torch.device("cuda")
    tok = ChineseCharTokenizer(synthetic_vocab(cfg.model.bart.vocab_size))
    spec = RegionSpec.from_channel_names(synthetic_montage())
    model = build_model(cfg.model, T, seed=0, device=dev)
    dtype = getattr(torch, args.compute_dtype)
    decode_fn = build_decode_fn(cfg, tok, spec, model, device=dev, fold_bn=True,
                                compute_dtype=dtype)
    windows = np.random.default_rng(1).normal(size=(16, 125, T)).astype(np.float32)

    # the encoder alone, on the same folded weights and preprocessed input
    enc_model = fold_batch_norm(model).to(dtype).to(dev).eval()
    R, C = spec.channel_mask.shape
    mask = torch.as_tensor(spec.channel_mask, device=dev)
    with torch.inference_mode():
        clean = SignalFrontend(cfg.frontend).preprocess(torch.from_numpy(windows).to(dev))
        stacked = clean[:, torch.as_tensor(spec.gather_indices.reshape(-1), device=dev)]
        stacked = torch.where(mask[None, :, :, None], stacked.reshape(16, R, C, T), 0.0)
        stacked = stacked.to(dtype)
        enc_s = segment_ms(lambda: enc_model.encode(stacked, mask), dev, 5) / 1e3
    del enc_model

    batch_s = segment_ms(lambda: decode_fn(windows), dev, 5) / 1e3
    print(f"{args.compute_dtype} batch {batch_s:.4f} s (median of 5 after a warm-up), "
          f"{16 / batch_s:.2f} windows/s; encode {enc_s:.4f} s (median of 5 after a warm-up)",
          flush=True)

    print_profile(lambda: decode_fn(windows), trace_dir, batch_s)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
