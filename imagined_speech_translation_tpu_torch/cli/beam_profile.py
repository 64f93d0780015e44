"""Beam-decode internals profiler on one CUDA card: where the decode loop's
time goes.

Port of ``tools/beam_profile.py``.  Each program runs 16 iterations, as the
decode loop does, at B = 16, beam 3, the full vocabulary, bf16:

* ``step16``   — 16 decode steps alone (6 BART layers + lm_head, greedy
  feedback), no beam bookkeeping, no cache gather;
* ``lmhead16`` — the ``d_model x vocab`` lm_head product alone;
* ``topk16``   — the beam's top-2K over ``(B, K*V)`` alone: the port's
  ``decode.search._top_k`` (2K argmax passes, ties by the lowest index as
  ``lax.top_k`` breaks them), which is what the beam runs;
  ``topk16_library_ms`` times ``torch.topk`` at the same shape beside it,
  a call the port does not make;
* ``gather16`` — the per-step beam cache reorder (``_gather_beams``) alone;
* ``beam``     — the whole beam search after the encoder: the served
  search itself, ``decode.generate.build_search_fn`` (the cross-attention
  constants, then ``decode.search.beam_search``).

The step is the one the port serves: ``decode_step_const`` with the
cross-attention hoisted as per-layer constants (``cross_consts``, computed
once a call), as ``decode.generate.build_generate_fn`` runs it, and not the
JAX tool's ``decode_step``, which recomputes the cross-attention every
step.  So ``step16 + topk16 + gather16`` reads against ``beam_ms`` (the beam
runs 15 steps, each with a log-softmax and the finished-hypothesis
bookkeeping besides).

The port launches each iteration from the host where the JAX tool runs one
device program (a ``fori_loop``), so a program's wall time (median of
8 after a warm-up, host clock between two synchronizes;
``roundtrip_ms`` is an empty synchronize, reported and not subtracted)
stands beside the busy device milliseconds and kernel launches of one
profiled run (``device_ms``, ``launches``) and the port's kernel launches by
name (``kernel_launches``).

    python -m imagined_speech_translation_tpu_torch.cli.beam_profile [--device cuda|cpu]

``default_config()``, random weights from seed 0 cast to bf16 (BatchNorm
unfolded, as in the JAX tool), decode length pinned to
``generation.max_length``.  Writes ``runs/torch_profile/beam_segments.json``;
the first printed line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config, default_config
from ..decode import build_search_fn
from ..decode.search import DecodeParams, _gather_beams, _top_k
from ..models import build_model
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

PROGRAMS = ("step16", "lmhead16", "topk16", "topk16_library", "gather16", "beam")
DEFAULT_OUT = Path("runs/torch_profile/beam_segments.json")
ITERS = 8  # the JAX tool's


def decode_params(cfg: Config) -> DecodeParams:
    """Beam ``generation.num_beams``, length pinned to ``generation.max_length``,
    the decoder's special ids (as the JAX tool sets them)."""
    bart, gen = cfg.model.bart, cfg.generation
    return DecodeParams(
        max_length=gen.max_length, min_length=gen.max_length, num_beams=gen.num_beams,
        pad_token_id=bart.pad_token_id, eos_token_id=bart.eos_token_id,
        decoder_start_token_id=bart.decoder_start_token_id,
    )


def bf16_model(cfg: Config, device):
    """The full model, random weights from seed 0, cast to bf16, eval mode."""
    return build_model(cfg.model, cfg.data.n_timepoints, seed=0, device=device).to(torch.bfloat16)


def build_programs(cfg: Config, device, batch: int = 16) -> dict:
    """One callable per program, over one bf16 model and one encoder output
    of ``batch`` windows."""
    device = torch.device(device)
    dp = decode_params(cfg)
    K, L, V = dp.num_beams, dp.max_length, cfg.model.bart.vocab_size
    BK = batch * K
    model = bf16_model(cfg, device)
    rng = np.random.default_rng(1)
    eeg = torch.from_numpy(rng.normal(size=(batch, 4, 16, cfg.data.n_timepoints))
                           .astype(np.float32)).to(device, torch.bfloat16)
    with torch.inference_mode():
        _, enc = model.encode(eeg, channel_mask(cfg, device))
    enc_x = enc.repeat_interleave(K, dim=0)
    emb = model.bart.shared.weight
    h0 = torch.from_numpy(np.random.default_rng(2).normal(size=(BK, emb.shape[1]))
                          .astype(np.float32)).to(device, emb.dtype)
    scores = torch.from_numpy(np.random.default_rng(0).normal(size=(batch, K * V))
                              .astype(np.float32)).to(device)

    def step16():
        caches = model.init_cache(BK, L, enc.dtype, device)
        consts = model.cross_consts(enc_x)
        tokens = torch.full((BK, 1), dp.decoder_start_token_id, dtype=torch.long, device=device)
        acc = torch.zeros((), device=device)
        for cur in range(L):
            pos = torch.full((BK, 1), cur, dtype=torch.long, device=device)
            logits = model.decode_step_const(tokens, pos, consts, caches)
            tokens = logits[:, -1].argmax(dim=-1, keepdim=True)
            acc = acc + logits.float().sum()
        return acc

    def lmhead16():
        acc = torch.zeros((), device=device)
        for _ in range(L):
            acc = acc + F.linear(h0, emb).float().sum()
        return acc

    def topk(fn):
        def run():
            acc = torch.zeros((), device=device)
            for cur in range(L):
                vals, idx = fn(scores + cur * 1e-6)
                acc = acc + vals.sum() + idx.sum()
            return acc
        return run

    def gather16():
        caches = model.init_cache(BK, L, enc.dtype, device)
        acc = torch.zeros((), device=device)
        for cur in range(L):
            parent = (torch.arange(K, device=device)[None].expand(batch, K) + cur) % K
            _gather_beams(caches, parent, batch, K)
            acc = acc + caches[0]["k"].float().sum()
        return acc

    search = build_search_fn(model, dp)

    programs = dict(step16=step16, lmhead16=lmhead16, topk16=topk(lambda s: _top_k(s, 2 * K)),
                    topk16_library=topk(lambda s: torch.topk(s, 2 * K)),
                    gather16=gather16, beam=lambda: search(enc).sum())
    return {name: torch.inference_mode()(fn) for name, fn in programs.items()}


def run(cfg: Config, device, *, iters: int, batch: int = 16, smi: str = "cpu") -> dict:
    """The report at ``cfg`` on ``device``."""
    device = torch.device(device)
    reset_peak_memory(device)
    programs = build_programs(cfg, device, batch)
    report = {"roundtrip_ms": roundtrip_ms(device, iters)}
    profs = {}
    for name in PROGRAMS:
        report[f"{name}_ms"], profs[name] = time_program(f"{name}_ms", programs[name], device,
                                                         iters)
    report.update(by_program(profs), peak_memory_gib=peak_memory_gib(device), card=smi)
    return report


def main(argv=None, *, cfg: Config | None = None) -> int:
    """The CLI; ``cfg`` replaces ``default_config()`` (the tests' tiny one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device, smi = open_device(args.device)
    report = run(cfg or default_config(), device, iters=ITERS, smi=smi)
    write_report(report, DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
