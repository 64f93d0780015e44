"""Training-window segment profiler on one CUDA card.

Port of ``tools/train_profile.py``.  It times sub-programs of the full
gradient-accumulation window on the same state and batch, so each cost
bucket is read by program subtraction:

* ``window``     — the full train step (``training.make_train_step``:
  accumulation, clip, AdamW);
* ``grads_only`` — the step's accumulation alone (``train_step.accumulate``:
  the bf16 copy and the micro-steps' forward and backward, no clip or
  update);
* ``fwd_only``   — the same accumulation with ``backward=False``: the losses
  under ``torch.no_grad`` in train mode, on the same dropout streams;
* ``micro_grad`` — one micro-step's forward and backward (the accumulation
  of a one-micro-step window, copy included);
* ``ce_only``    — the full step with ``training.loss.composite=False``
  (isolates the loss heads);
* ``cast``       — the window's bf16 copy of the parameters
  (``training.train_step.forward_copy``);
* ``optimizer``  — clip + AdamW on precomputed gradients
  (``train_step.update``).

Derived rows, with the JAX tool's names: optimizer+clip = window -
grads_only; backward = grads_only - fwd_only; accumulation overhead =
grads_only - accum * micro_grad; loss heads = window - ce_only.

Every segment starts from the same state: train-mode BatchNorm updates its
running statistics in place and the update changes the parameters and the
optimizer state, so a copy of all of them, taken once, is restored after
every run, outside the timed span.  A segment is the median wall time of
``--iters`` runs after a warm-up, on the host clock between two
synchronizes (``rtt`` is the cost of an empty synchronize, reported and not
subtracted: the JAX tool's round-trip correction was for a remote device).
The port launches every micro-step from the host where the JAX window is one
device program, so beside each wall time the report gives the busy device
milliseconds and the kernel launches of one profiled run (``device_ms``,
``launches``) and the port's own kernel launches by name
(``kernel_launches``): the gap between wall and device time is the host's.
``derived_device_ms`` are the derived rows on the device times: where the
host sets the wall time, its run-to-run spread can swamp a wall-time
difference, and the device times still subtract.

    python -m imagined_speech_translation_tpu_torch.cli.train_profile \\
        [--micro 4] [--accum 8] [--iters 5] [--json out.json] [--device cuda|cpu]

``default_config()`` with mixed precision (bf16), random weights from seed 0
and a synthetic window made with numpy.  The report is printed as JSON and
written to ``--json`` (``runs/torch_profile/train_segments.json`` by
default); the first printed line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..config import Config, default_config, replace_nested
from ..training import (
    AdaptiveLossScheduler,
    FusedAdamW,
    build_train_module,
    create_train_state,
    make_train_step,
)
from ..training.train_step import forward_copy
from .profile_slice import (
    by_program,
    channel_mask,
    open_device,
    peak_memory_gib,
    reset_peak_memory,
    roundtrip_ms,
    time_program,
    write_report,
)

SEGMENTS = ("window", "grads_only", "fwd_only", "micro_grad", "ce_only", "cast", "optimizer")
DEFAULT_OUT = Path("runs/torch_profile/train_segments.json")


def profile_config(micro: int, accum: int, cfg: Config | None = None) -> Config:
    """``cfg`` (``default_config()``) with mixed precision, micro-batch
    ``micro`` and ``accum`` accumulation steps."""
    cfg = replace_nested(cfg or default_config(), "training.mixed_precision", True)
    cfg = replace_nested(cfg, "training.grad_accum_steps", accum)
    return replace_nested(cfg, "training.batch_size", micro)


def synthetic_window(cfg: Config, device, seed: int = 0) -> dict:
    """A window ``(accum, micro, ...)`` made with numpy, as the JAX tool
    makes it: normal EEG, decoder inputs in ``[0, 1000)`` with the labels
    equal to them, every position attended, the shared channel mask."""
    tc = cfg.training
    accum, micro = tc.grad_accum_steps, tc.batch_size
    L, T = cfg.data.max_length, cfg.data.n_timepoints
    rng = np.random.default_rng(seed)
    mask = channel_mask(cfg).numpy()
    ids = rng.integers(0, min(1000, cfg.model.bart.vocab_size), (accum, micro, L))
    arrays = dict(
        eeg=rng.normal(size=(accum, micro) + mask.shape + (T,)).astype(np.float32),
        decoder_input_ids=ids, labels=ids, attention_mask=np.ones((accum, micro, L), np.int32),
        channel_mask=mask,
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


@dataclasses.dataclass
class Programs:
    """The segments' programs over one train state.  :meth:`run` runs one
    and then restores the state it started from; :meth:`restore` is what
    the timer calls after every run."""

    state: object
    step: object          # the window's train step
    programs: dict
    _saved: list          # (tensor, its copy at the start)

    def restore(self) -> None:
        with torch.no_grad():
            for t, saved in self._saved:
                t.copy_(saved)
        self.state.step = 0
        self.state.opt_state.count = 0

    def run(self, name: str):
        out = self.programs[name]()
        self.restore()
        return out


def build_step(cfg: Config, device, *, seed: int = 0):
    """``(state, optimizer, bow, window)`` of ``cfg`` on ``device``: random
    weights from ``seed``, the bag-of-words ids drawn with numpy from it."""
    tc = cfg.training
    bow = np.random.default_rng(seed).integers(0, cfg.model.bart.vocab_size,
                                               tc.loss.bow_vocab_size)
    module = build_train_module(cfg, len(bow), seed=seed, device=device)
    opt = FusedAdamW([n for n, _ in module.named_parameters()], tc.optimizer, total_steps=1000)
    state = create_train_state(module, opt, AdaptiveLossScheduler(tc.loss).initial_weights())
    return state, opt, bow, synthetic_window(cfg, device, seed)


def build_programs(cfg: Config, device, *, seed: int = 0) -> Programs:
    """The train state of ``cfg`` on ``device`` (:func:`build_step`), its
    window, and one program per segment."""
    tc = cfg.training
    state, opt, bow, batch = build_step(cfg, device, seed=seed)
    module = state.module
    step = make_train_step(module, opt, cfg, bow)
    ce_step = make_train_step(module, opt, replace_nested(cfg, "training.loss.composite", False),
                              bow)
    micro_step = make_train_step(module, opt, replace_nested(cfg, "training.grad_accum_steps", 1),
                                 bow)
    micro = {k: v if k == "channel_mask" else v[:1] for k, v in batch.items()}
    tensors = [*module.parameters(), *module.buffers(), *state.opt_state.mu.values(),
               *state.opt_state.nu.values()]
    saved = [(t, t.detach().clone()) for t in tensors]

    def key():
        return torch.Generator().manual_seed(1)

    progs = Programs(state, step, {}, saved)
    grads, _ = step.accumulate(state, batch, key())  # the optimizer's input
    progs.restore()
    progs.programs.update(
        window=lambda: step(state, batch, key())[1],
        grads_only=lambda: step.accumulate(state, batch, key()),
        fwd_only=lambda: step.accumulate(state, batch, key(), backward=False),
        micro_grad=lambda: micro_step.accumulate(state, micro, key()),
        ce_only=lambda: ce_step(state, batch, key())[1],
        cast=lambda: forward_copy(dict(module.named_parameters()), tc.mixed_precision),
        optimizer=lambda: step.update(state, grads, {}),
    )
    return progs


def derived_ms(ms: dict, accum: int) -> dict:
    """The JAX tool's four derived rows, by its names."""
    return {
        "clip+adamw+apply (window - grads_only)": ms["window"] - ms["grads_only"],
        "backward (grads_only - fwd_only)": ms["grads_only"] - ms["fwd_only"],
        f"accum overhead (grads_only - {accum}*micro_grad)":
            ms["grads_only"] - accum * ms["micro_grad"],
        "aux loss heads (window - ce_only)": ms["window"] - ms["ce_only"],
    }


def run(cfg: Config, device, *, iters: int, smi: str = "cpu",
        progs: Programs | None = None) -> dict:
    """The report of every segment at ``cfg`` on ``device``, over ``progs``
    (:func:`build_programs`, built here when not given)."""
    device = torch.device(device)
    if progs is None:
        reset_peak_memory(device)
        progs = build_programs(cfg, device)
    ms, profs = {"rtt": roundtrip_ms(device, iters)}, {}
    for name in SEGMENTS:
        ms[name], profs[name] = time_program(name, progs.programs[name], device, iters,
                                             after=progs.restore)
    extra = by_program(profs)
    tc = cfg.training
    n = tc.grad_accum_steps * tc.batch_size
    return {
        "segments_ms": ms,
        "derived_ms": derived_ms(ms, tc.grad_accum_steps),
        "derived_device_ms": (derived_ms(extra["device_ms"], tc.grad_accum_steps)
                              if device.type == "cuda" else None),
        "windows_per_sec": n / (ms["window"] / 1e3),
        **extra,
        "peak_memory_gib": peak_memory_gib(device),
        "card": smi,
    }


def main(argv=None, *, cfg: Config | None = None) -> int:
    """The CLI; ``cfg`` replaces ``default_config()`` (the tests' tiny one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", default=None,
                    help=f"where to write the report (default {DEFAULT_OUT})")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device, smi = open_device(args.device)
    report = run(profile_config(args.micro, args.accum, cfg), device, iters=args.iters, smi=smi)
    write_report(report, Path(args.json) if args.json else DEFAULT_OUT)
    print(f"window {report['segments_ms']['window']:.1f} ms = "
          f"{report['windows_per_sec']:.1f} windows/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
