"""Trace a hot path of the port (encode / generate / the eval-mode gradient)
with ``torch.profiler``.

Port of ``imagined_speech_translation_tpu.cli.profile``::

    python -m imagined_speech_translation_tpu_torch.cli.profile \
        --out build/profile/train [--what encode|generate|train] [--batch 8]
        [--tiny] [--iters 3] [--device cuda|cpu]

The model is ``default_config()``'s (``--tiny``: the JAX script's small
widths) with float32 random weights from seed 0, in eval mode; the inputs
come from ``numpy.random.default_rng(0)`` in the JAX script's order: EEG
``(B, 4, 16, T)``, then decoder ids and labels of 8 tokens.  ``encode`` runs
``model.encode``; ``generate`` beam 3 with max length 16 and min length 4;
``train`` the gradient of ``cross_entropy_loss`` over the eval-mode forward
(dropout off, BatchNorm on its running statistics) with respect to the
parameters only, so every flash attention's backward runs at dropout rate 0
(the split dQ and dK/dV kernels on the card).

One untraced run first (it builds the kernels), then ``--iters`` runs, each
annotated ``<what>_<i>`` and timed on the host clock around synchronized
calls, under ``utils.profiling.trace`` (through ``cli.profile_slice.
traced_run``, which takes the iterations again if the card's trace lost
device records), which writes ``<out>/trace.json``.  On the card the device
time by kernel name follows (``cli.profile_slice.device_summary``).  The default device is the card; ``--device cpu`` runs the
plain twins of the kernels.  ``--tiny`` has head dims 12 and 24: the flash
kernels take 12 on their CUDA-core variants and 24, a multiple of 8, on the
float32 tensor-core (3xTF32) ones.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from ..config import default_config, replace_nested
from ..decode import DecodeParams, build_generate_fn
from ..models import build_model
from ..models.bart import cross_entropy_loss
from ..utils.cache import enable_persistent_cache
from ..utils.profiling import annotate
from .profile_slice import device_summary, traced_run

logger = logging.getLogger(__name__)

TINY_OVERRIDES = (
    ("model.hidden_dim", 48),
    ("model.brain_encoder.hidden_dim", 48),
    ("model.brain_encoder.fusion_heads", 4),
    ("model.brain_encoder.cross_region_heads", 4),
    ("model.brain_encoder.region_encoder.conv_channels", (8, 16, 24, 32, 48)),
    ("model.brain_encoder.region_encoder.attn_heads", (4, 2, 2)),
    ("model.brain_encoder.region_encoder.se_reduction", 4),
    ("model.bart.d_model", 48),
    ("model.bart.vocab_size", 256),
    ("model.bart.decoder_layers", 2),
    ("model.bart.num_heads", 4),
    ("model.bart.ffn_dim", 96),
    ("data.n_timepoints", 128),
)


def profile_config(tiny: bool = False):
    """``default_config()``, with the JAX script's ``--tiny`` overrides."""
    cfg = default_config()
    for path, value in TINY_OVERRIDES if tiny else ():
        cfg = replace_nested(cfg, path, value)
    return cfg


def profile_inputs(cfg, batch: int, device) -> dict[str, torch.Tensor]:
    """The JAX script's inputs: channel mask of the configured region
    counts, EEG, decoder ids and labels, drawn in that order from seed 0."""
    rng = np.random.default_rng(0)
    mask = np.zeros((4, 16), bool)
    for r, c in enumerate(cfg.model.region_channel_counts):
        mask[r, :c] = True
    vocab = cfg.model.bart.vocab_size
    arrays = dict(
        mask=mask,
        eeg=rng.normal(size=(batch, 4, 16, cfg.data.n_timepoints)).astype(np.float32),
        ids=rng.integers(0, vocab, (batch, 8)),
        labels=rng.integers(0, vocab, (batch, 8)),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def build_program(what: str, model, cfg, inputs):
    """The function the script traces for ``what``."""
    eeg, mask = inputs["eeg"], inputs["mask"]
    if what == "encode":
        return torch.inference_mode()(lambda: model.encode(eeg, mask))
    if what == "generate":
        bart = cfg.model.bart
        gen = build_generate_fn(model, DecodeParams(
            max_length=16, min_length=4, num_beams=3, pad_token_id=bart.pad_token_id,
            eos_token_id=bart.eos_token_id, decoder_start_token_id=bart.decoder_start_token_id,
        ))
        return lambda: gen(eeg, mask)
    if what != "train":
        raise ValueError(f"unknown program {what!r}")
    params = list(model.parameters())

    def grads():
        logits = model(eeg, inputs["ids"], mask)
        return torch.autograd.grad(cross_entropy_loss(logits, inputs["labels"])[0], params)

    return grads


def main(argv=None) -> dict:
    """Runs the script; returns the trace's path, the traced iterations'
    seconds, the last iteration's output and how many times the program ran
    (the warm-up, and every traced iteration, those of a refused trace
    too)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory of the Chrome trace")
    ap.add_argument("--what", choices=("encode", "generate", "train"), default="encode")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true", help="the JAX script's tiny config")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    enable_persistent_cache()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    cfg = profile_config(args.tiny)
    model = build_model(cfg.model, cfg.data.n_timepoints, seed=0, device=device)
    run = build_program(args.what, model, cfg, profile_inputs(cfg, args.batch, device))

    logger.info("warming up %s ...", args.what)
    run()
    sync()
    logger.info("tracing %d iterations to %s", args.iters, args.out)
    seconds, out, runs = [], None, 1

    def iterations():
        nonlocal out, runs
        runs += args.iters
        seconds.clear()
        for i in range(args.iters):
            t0 = time.perf_counter()
            with annotate(f"{args.what}_{i}"):
                out = run()
            sync()
            seconds.append(time.perf_counter() - t0)

    path = traced_run(iterations, args.out)
    logger.info("trace written to %s; seconds per iteration under the profiler: %s", path,
                [round(s, 4) for s in seconds])
    if device.type == "cuda":
        s = device_summary(json.loads(path.read_text())["traceEvents"])
        logger.info("device busy %.1f ms of a %.1f ms span (idle share %.3f), %d launches",
                    s["busy_ms"], s["span_ms"], s["idle_share"], s["launches"])
        for name, ms, count in s["by_name"][:12]:
            logger.info("  %9.3f ms  n=%5d  %s", ms, count, name[:90])
    return dict(trace=path, seconds=seconds, out=out, runs=runs)


if __name__ == "__main__":
    main()
