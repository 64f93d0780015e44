"""Serve the streaming EEG->text pipeline over websockets.

Port of ``imagined_speech_translation_tpu.cli.serve``.  The end-to-end
product path (SURVEY.md §3.5): device streams EEG bytes -> wake gate ->
windowed preprocess -> decode on the card -> text back to the client.
Loads a trained checkpoint (or random weights with ``--random-init`` for
smoke testing), builds the decode function, and runs the
``runtime.server.WssService``.

Usage::

    python -m imagined_speech_translation_tpu_torch.cli.serve \\
        --montage data/montage.csv --vocab vocab.txt \\
        [--checkpoint runs/latest/checkpoints/best_model] [--port 4040] \\
        [--max-batch 16] [--random-init] [--device cpu]

``--checkpoint`` takes a checkpoint directory of ``cli.train`` (its
``state.pt``: the ``model.*`` entries of the trained module, BatchNorm
running statistics included; the loss heads and the optimizer state are
ignored) or a file holding a model ``state_dict`` (``torch.save``); either
loads strictly.  ``--device`` stands in for the JAX script's
``--platform``: the card by default, ``cpu`` on request, and without a card
the script raises instead of falling back.  ``--data-parallel`` above 1
(a decode batch sharded over several cards) is refused: multi-device
serving is not ported.  The JAX script's persistent compile cache has no
counterpart: the kernels build once into ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import functools
import logging
from pathlib import Path

import numpy as np
import torch

from ..config import Config, replace_nested
from ..data import ChineseCharTokenizer, RegionSpec, load_montage
from ..decode import DecodeParams, build_generate_fn
from ..frontend import SignalFrontend
from ..models import EEGDecodingModel, build_model, fold_batch_norm

logger = logging.getLogger(__name__)

NO_DATA_PARALLEL = ("--data-parallel > 1 (one decode batch sharded over several cards) is not "
                    "ported: multi-device serving is ROADMAP item 1.7")


def build_decode_fn(cfg: Config, tokenizer, region_spec, model: EEGDecodingModel, *,
                    device, fold_bn: bool = True, compute_dtype: torch.dtype | None = None,
                    transfer_dtype=None):
    """``(N, n_ch, T)`` numpy windows -> ``list[str]``.

    The IIR runs in float32 on the raw windows; with ``compute_dtype`` (e.g.
    ``torch.bfloat16``) the model's weights are cast after the float32
    BatchNorm fold and the activations after the IIR.  ``model`` itself is
    left unchanged.

    ``transfer_dtype=np.float16`` casts the raw windows on the host and
    back up to float32 on the device before the IIR: half the
    host-to-device bytes a call.  float16 keeps about three decimal digits,
    far below the noise of raw EEG, but the tokens are no longer pinned to
    the float32 wire's, so the mode stays opt-in."""
    device = torch.device(device)
    wire = np.dtype(transfer_dtype if transfer_dtype is not None else np.float32)
    if fold_bn:
        model = fold_batch_norm(model)  # a folded copy, in float32
    elif compute_dtype is not None:
        model = copy.deepcopy(model)
    if compute_dtype is not None:
        model = model.to(compute_dtype)
    model = model.to(device).eval()
    frontend = SignalFrontend(cfg.frontend)
    dp = DecodeParams(
        max_length=cfg.generation.max_length,
        min_length=cfg.generation.min_length,
        num_beams=cfg.generation.num_beams,
        pad_token_id=tokenizer.pad_token_id,
        eos_token_id=tokenizer.sep_token_id,
        decoder_start_token_id=tokenizer.bos_token_id,
    )
    generate = build_generate_fn(model, dp)
    gather = torch.as_tensor(region_spec.gather_indices.reshape(-1), device=device)
    mask = torch.as_tensor(region_spec.channel_mask, device=device)
    R, C = mask.shape
    T = cfg.data.n_timepoints

    @torch.inference_mode()
    def decode_fn(windows: np.ndarray) -> list[str]:
        # a half-precision wire is cast up before the (f32-sensitive) IIR; a
        # read-only batch (a decode worker's pipe buffer) is copied first
        raw = torch.from_numpy(np.require(windows, wire, "W")).to(device).float()
        clean = frontend.preprocess(raw)
        stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
        stacked = torch.where(mask[None, :, :, None], stacked, 0.0)
        if compute_dtype is not None:
            stacked = stacked.to(compute_dtype)
        tokens = generate(stacked, mask).cpu().numpy()
        return [t.strip() for t in tokenizer.batch_decode(tokens)]

    return decode_fn


def serving_context(config: str | None, vocab: str, montage: str):
    """``(cfg, tokenizer, region_spec)``: the config (``config`` JSON or
    ``default_config()``) with the vocabulary size set to the tokenizer's."""
    from .train import load_config

    cfg = load_config(config, None)
    tokenizer = ChineseCharTokenizer.from_vocab_file(vocab)
    if tokenizer.vocab_size != cfg.model.bart.vocab_size:
        cfg = replace_nested(cfg, "model.bart.vocab_size", tokenizer.vocab_size)
    return cfg, tokenizer, RegionSpec.from_channel_names(load_montage(montage))


def load_serving_state_dict(checkpoint: str | Path) -> dict[str, torch.Tensor]:
    """The ``EEGDecodingModel`` state of a checkpoint, on the CPU.

    ``checkpoint`` is a directory of ``training.CheckpointManager`` (or its
    ``state.pt``), whose ``module`` holds the trained ``TrainModule``: its
    ``model.*`` entries are returned with the prefix stripped, BatchNorm
    running statistics included, and the loss heads, the optimizer state
    and the loss weights are left out; or a file holding a model
    ``state_dict``, returned as it is."""
    path = Path(checkpoint)
    if path.is_dir():
        path = path / "state.pt"
    # mmap: the optimizer state of a trainer checkpoint is never read
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(saved.get("module"), dict):
        saved = {k[len("model."):]: v for k, v in saved["module"].items()
                 if k.startswith("model.")}
    return saved


def build_decode_fn_from_args(
    *,
    vocab: str,
    montage: str,
    config: str | None = None,
    checkpoint: str | None = None,
    random_init: bool = False,
    data_parallel: int = 0,
    compute_dtype: str | None = None,
    transfer_dtype: str | None = None,
    max_batch: int = 1,
    device: str = "cuda",
):
    """Build and warm the serving ``decode_fn`` from plain (picklable)
    arguments, so the whole build can run in the server process or inside
    a ``runtime.worker.DecodeWorker`` child, which then owns the card.

    Without ``checkpoint``, or with ``random_init``, the weights are random
    from seed 0 (smoke mode).  ``device="cuda"`` without a card raises."""
    if data_parallel > 1:
        raise NotImplementedError(NO_DATA_PARALLEL)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) to serve on the CPU")
    cfg, tokenizer, spec = serving_context(config, vocab, montage)
    T = cfg.data.n_timepoints
    model = build_model(cfg.model, T, seed=0, device=device)
    if checkpoint and not random_init:
        model.load_state_dict(load_serving_state_dict(checkpoint))
        logger.info("loaded checkpoint %s", checkpoint)
    else:
        logger.warning("serving with random weights (smoke mode)")
    decode_fn = build_decode_fn(
        cfg, tokenizer, spec, model, device=device,
        compute_dtype=getattr(torch, compute_dtype) if compute_dtype else None,
        transfer_dtype=np.dtype(transfer_dtype) if transfer_dtype else None,
    )
    n_ch = int(spec.gather_indices.max() + 1)
    logger.info("warming up the decode function...")
    decode_fn(np.zeros((max(1, max_batch), n_ch, T), np.float32))
    logger.info("decode function ready")
    return decode_fn


def build_service(decode_fn, *, n_channels: int, window: int, hop: int | None = None,
                  wake_threshold: float = 0.0, max_batch: int = 1, max_delay_ms: float = 25.0,
                  worker=None):
    """The websocket service as ``main`` wires it: per session a ring buffer,
    a windower and an optional RMS wake gate, feeding either its own
    ``DecodePipeline`` or, with ``max_batch > 1``, a ``BatchingDecodePipeline``
    on one ``BatchScheduler`` shared by every session; the reference command
    table plus ``latency``.  Returns ``(service, scheduler)``; the scheduler
    (None without pooling) must be running while the service decodes."""
    from ..runtime import (
        BatchingDecodePipeline,
        BatchScheduler,
        DecodePipeline,
        RingBuffer,
        SessionRegistry,
        ThresholdWakeGate,
        Windower,
    )
    from ..runtime.commands import build_command_registry
    from ..runtime.server import WssService
    from ..runtime.services import ServiceBundle

    scheduler = None
    if max_batch > 1:
        scheduler = BatchScheduler(decode_fn, max_batch=max_batch, max_delay_ms=max_delay_ms)

    def pipeline_factory(key: str):
        ring = RingBuffer(n_channels, capacity=4 * window)
        gate = ThresholdWakeGate(wake_threshold) if wake_threshold else None
        if scheduler is not None:
            return BatchingDecodePipeline(
                windower=Windower(ring, window=window, hop=hop or window),
                scheduler=scheduler,
                wake_gate=gate,
            )
        return DecodePipeline(
            windower=Windower(ring, window=window, hop=hop or window),
            decode_fn=decode_fn,
            wake_gate=gate,
            max_batch=1,
        )

    # the full reference command table (wss/wss.js:52-68) rides alongside the
    # decode pipeline so companion clients get the complete control plane
    bundle = ServiceBundle()
    registry = build_command_registry(bundle, registry=SessionRegistry())

    @registry.command("latency")
    async def latency(session, a):
        out = {}
        if scheduler is not None:
            out["pooled"] = scheduler.stats()
        else:
            out.update({k: p.latency.summary() for k, p in service._pipelines.items()})
        if worker is not None:
            out["decode_worker"] = worker.stats()
        return out

    service = WssService(registry, pipeline_factory=pipeline_factory, n_channels=n_channels,
                         services=bundle)
    return service, scheduler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--montage", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint directory of cli.train, or a model state_dict file")
    ap.add_argument("--config", default=None)
    ap.add_argument("--random-init", action="store_true")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=4040)
    ap.add_argument("--window-hop", type=int, default=None)
    ap.add_argument("--wake-threshold", type=float, default=0.0)
    ap.add_argument(
        "--max-batch", type=int, default=1,
        help=">1 pools windows from ALL sessions into fixed-shape decode "
        "batches (runtime.batcher.BatchScheduler)",
    )
    ap.add_argument(
        "--max-delay-ms", type=float, default=25.0,
        help="batching deadline: launch at most this long after the oldest "
        "pending window arrived",
    )
    ap.add_argument(
        "--data-parallel", type=int, default=0,
        help="shard each decode batch over this many devices (0 = single "
        "device); above 1 it is refused: multi-device serving is not ported",
    )
    ap.add_argument(
        "--compute-dtype", default=None, choices=("bfloat16", "float32"),
        help="serving compute dtype (float32 without it); the IIR preprocess and "
        "the BatchNorm fold stay float32",
    )
    ap.add_argument(
        "--transfer-dtype", default=None, choices=("float16", "float32"),
        help="host->device wire dtype for raw windows; float16 halves "
        "transfer bytes (cast up to float32 on the device before the IIR)",
    )
    ap.add_argument(
        "--decode-worker-budget-mb", type=float, default=0.0,
        help="run the decode function in a CHILD process recycled when its "
        "RSS crosses this budget (runtime/worker.py); 0 = in-process decode",
    )
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.data_parallel > 1:
        ap.error(NO_DATA_PARALLEL)

    from .train import check_device

    check_device(args.device)
    # host-only context the SERVER needs (no device touched here)
    cfg, _, spec = serving_context(args.config, args.vocab, args.montage)
    T = cfg.data.n_timepoints
    n_ch = int(spec.gather_indices.max() + 1)  # raw montage channels expected

    fargs = dict(
        vocab=args.vocab, montage=args.montage, config=args.config,
        checkpoint=args.checkpoint, random_init=args.random_init,
        data_parallel=args.data_parallel, compute_dtype=args.compute_dtype,
        transfer_dtype=args.transfer_dtype, max_batch=args.max_batch,
        device=args.device,
    )
    worker = None
    if args.decode_worker_budget_mb > 0:
        from ..runtime.worker import DecodeWorker

        worker = DecodeWorker(
            functools.partial(build_decode_fn_from_args, **fargs),
            rss_budget_mb=args.decode_worker_budget_mb,
        )
        worker.start()  # spawns the child, builds + warms the decode function there
        decode_fn = worker
    else:
        decode_fn = build_decode_fn_from_args(**fargs)

    service, scheduler = build_service(
        decode_fn, n_channels=n_ch, window=T, hop=args.window_hop,
        wake_threshold=args.wake_threshold, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, worker=worker,
    )
    logger.info("serving on %s:%d (window=%d, channels=%d)", args.host, args.port, T, n_ch)

    async def amain():
        if scheduler is not None:
            async with scheduler:
                await service.serve(args.host, args.port)
        else:
            await service.serve(args.host, args.port)

    try:
        asyncio.run(amain())
    finally:
        if worker is not None:
            worker.stop()


if __name__ == "__main__":
    main()
