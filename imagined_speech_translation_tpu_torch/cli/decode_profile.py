"""Decode-path segment profiler on one CUDA card: frontend, encoder and beam
timings of a batch, plus the JAX tool's ablation toggles.

Port of ``tools/decode_profile.py``.  Segments, at ``default_config()`` with
random weights from seed 0 cast to bf16 (BatchNorm unfolded, as in the JAX
tool) and the decode length pinned to ``generation.max_length``:

* ``frontend`` — ``SignalFrontend.preprocess`` of ``(B, 125, T)`` float32 raw
  windows: the IIR kernel (``csrc/sosfilt.cu``, one launch) and the
  common-average reference;
* ``encoder``  — ``EEGDecodingModel.encode`` of the ``(B, 4, 16, T)`` bf16
  region tensor (the flash forward, ``2 * num_attn_layers - 1`` launches);
* ``beam``     — beam search on one encoder output: the served search,
  ``decode.generate.build_search_fn`` (the hoisted cross-attention
  constants computed once a call; the port has no unhoisted decode step),
  the program ``cli.beam_profile`` times as ``beam``;
* ``full``     — the serving entry point itself, ``cli.serve.
  build_decode_fn`` (BatchNorm unfolded, bf16, a tokenizer over a synthetic
  vocabulary of the configured size), on ``(B, 125, T)`` float32 numpy
  windows of a 125-channel montage: the upload, the frontend, the region
  gather, the encoder and the beam, the ids' readback and the tokenizer's
  ``batch_decode``.  The JAX tool's ``full`` starts at the region tensor on
  the device; the port's is what a served batch costs.
  ``windows_per_sec`` is ``B / full``.

A segment is the median wall time of 8 runs after a warm-up, on the host
clock between two synchronizes (``roundtrip_ms`` is an empty synchronize,
reported and not subtracted: the JAX tool's scalar-fetch and round-trip
corrections were for a remote device).  Beside it the report gives the busy
device milliseconds and kernel launches of one profiled run (``device_ms``,
``launches``) and the port's kernel launches by name (``kernel_launches``):
the gap between wall and device time is the host's.

Knobs, as the JAX tool's (environment variables)::

    python -m imagined_speech_translation_tpu_torch.cli.decode_profile
    HEADS=8,4,4 python -m imagined_speech_translation_tpu_torch.cli.decode_profile
    SEGMENTS=beam python -m imagined_speech_translation_tpu_torch.cli.decode_profile
    BENCH_BATCH=1 python -m imagined_speech_translation_tpu_torch.cli.decode_profile

``--device cpu`` runs on the CPU.  Writes
``runs/torch_profile/decode_segments.json``; the first printed line is the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from ..config import Config, default_config, replace_nested
from ..data import ChineseCharTokenizer, RegionSpec
from ..decode import build_search_fn
from ..frontend import SignalFrontend
from ..models import build_model
from .beam_profile import decode_params
from .profile_slice import (
    by_program,
    channel_mask,
    open_device,
    peak_memory_gib,
    reset_peak_memory,
    roundtrip_ms,
    synthetic_montage,
    synthetic_vocab,
    time_program,
    write_report,
)
from .serve import build_decode_fn

SEGMENTS = ("frontend", "encoder", "beam", "full")
DEFAULT_OUT = Path("runs/torch_profile/decode_segments.json")
ITERS = 8  # the JAX tool's


def with_heads(cfg: Config, heads: tuple[int, ...]) -> Config:
    """``cfg`` with the region encoder's ``attn_heads`` set (``HEADS``)."""
    be = cfg.model.brain_encoder
    be = dataclasses.replace(be, region_encoder=dataclasses.replace(be.region_encoder,
                                                                    attn_heads=heads))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, brain_encoder=be))


def build_programs(cfg: Config, device, batch: int = 16) -> dict:
    """One callable per segment: ``full`` over the serving entry point's own
    bf16 copy of the model, the others over the model cast to bf16."""
    device = torch.device(device)
    T = cfg.data.n_timepoints
    model = build_model(cfg.model, T, seed=0, device=device)
    served = replace_nested(cfg, "generation.min_length", cfg.generation.max_length)
    decode_fn = build_decode_fn(
        served, ChineseCharTokenizer(synthetic_vocab(cfg.model.bart.vocab_size)),
        RegionSpec.from_channel_names(synthetic_montage()), model, device=device,
        fold_bn=False, compute_dtype=torch.bfloat16)
    model = model.to(torch.bfloat16)
    mask = channel_mask(cfg, device)
    frontend = SignalFrontend(cfg.frontend)
    search = build_search_fn(model, decode_params(cfg))
    eeg = torch.from_numpy(np.random.default_rng(1).normal(size=(batch, 4, 16, T))
                           .astype(np.float32)).to(device, torch.bfloat16)
    windows = np.random.default_rng(2).normal(size=(batch, 125, T)).astype(np.float32)
    raw = torch.from_numpy(windows).to(device)
    with torch.inference_mode():
        _, enc = model.encode(eeg, mask)
    programs = dict(frontend=lambda: frontend.preprocess(raw),
                    encoder=lambda: model.encode(eeg, mask)[1], beam=lambda: search(enc))
    programs = {name: torch.inference_mode()(fn) for name, fn in programs.items()}
    return dict(programs, full=lambda: decode_fn(windows))


def run(cfg: Config, device, *, iters: int, batch: int = 16,
        segments: tuple[str, ...] = SEGMENTS, smi: str = "cpu") -> dict:
    """The report of ``segments`` at ``cfg`` on ``device``."""
    device = torch.device(device)
    reset_peak_memory(device)
    programs = build_programs(cfg, device, batch)
    report = {"config_heads": list(cfg.model.brain_encoder.region_encoder.attn_heads),
              "batch": batch, "roundtrip_ms": roundtrip_ms(device, iters)}
    profs = {}
    for name in segments:
        report[f"{name}_ms"], profs[name] = time_program(f"{name}_ms", programs[name], device,
                                                         iters)
    if "full" in segments:
        report["windows_per_sec"] = batch / (report["full_ms"] / 1e3)
    report.update(by_program(profs), peak_memory_gib=peak_memory_gib(device), card=smi)
    return report


def main(argv=None, *, cfg: Config | None = None) -> int:
    """The CLI; ``cfg`` replaces ``default_config()`` (the tests' tiny one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device, smi = open_device(args.device)
    cfg = cfg or default_config()
    if os.environ.get("HEADS"):
        cfg = with_heads(cfg, tuple(int(x) for x in os.environ["HEADS"].split(",")))
    segments = tuple(os.environ.get("SEGMENTS", ",".join(SEGMENTS)).split(","))
    report = run(cfg, device, iters=ITERS, batch=int(os.environ.get("BENCH_BATCH", "16")),
                 segments=segments, smi=smi)
    write_report(report, DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
