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
the script raises instead of falling back.  ``--data-parallel N`` holds one
replica of the folded, cast model on each of N cards (N CPU replicas with
``--device cpu``) and splits every decode batch over them in contiguous
rows, as the JAX script's SPMD mesh shards it; a batch must be a multiple
of N.  The JAX script's persistent compile cache has no counterpart: the
kernels build once into ``build/kernels/``.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
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
from ..parallel import make_mesh
from ..parallel.mesh import Mesh, split_batch
from ..utils.cache import enable_persistent_cache
from ..utils.memory import return_freed_buffers

logger = logging.getLogger(__name__)


def build_decode_fn(cfg: Config, tokenizer, region_spec, model: EEGDecodingModel, *,
                    device=None, fold_bn: bool = True,
                    compute_dtype: torch.dtype | None = None, transfer_dtype=None,
                    mesh: Mesh | None = None):
    """``(N, n_ch, T)`` numpy windows -> ``list[str]``.

    The IIR runs in float32 on the raw windows; with ``compute_dtype`` (e.g.
    ``torch.bfloat16``) the model's weights are cast after the float32
    BatchNorm fold and the activations after the IIR.  ``model`` itself is
    left unchanged.

    ``transfer_dtype=np.float16`` casts the raw windows on the host and
    back up to float32 on the device before the IIR: half the
    host-to-device bytes a call.  float16 keeps about three decimal digits,
    far below the noise of raw EEG, but the tokens are no longer pinned to
    the float32 wire's, so the mode stays opt-in.

    With ``mesh`` (a serving mesh, ``parallel.make_mesh(n, 1,
    devices=[...])``) instead of ``device``, one replica of the folded, cast
    model sits on each of the mesh's devices (a device may repeat); a batch
    splits into contiguous rows, one shard a replica, each shard runs on its
    replica's stream, and the ids come back in order.  ``N`` must then be a
    multiple of the shard count.

    A process that decodes on a card takes the serving memory policy
    (``utils.memory.return_freed_buffers``): freed host buffers of 128 KiB
    and more go back to the system.  A decode on the CPU keeps glibc's
    defaults: its activations come from the same heap, and mapping each
    of them anew makes its latency drift (``cli.streaming_soak`` on the
    CPU, several processes at once)."""
    if (mesh is None) == (device is None):
        raise ValueError("build_decode_fn takes a device or a serving mesh, one of them")
    if mesh is not None and mesh.over_ranks:
        raise ValueError("a serving mesh lists the devices of its replicas "
                         "(make_mesh(n, 1, devices=[...]))")
    enable_persistent_cache()
    wire = np.dtype(transfer_dtype if transfer_dtype is not None else np.float32)
    if fold_bn:
        model = fold_batch_norm(model)  # a folded copy, in float32
    elif compute_dtype is not None:
        model = copy.deepcopy(model)
    if compute_dtype is not None:
        model = model.to(compute_dtype)
    devices = [device] if mesh is None else mesh.devices
    if any(torch.device(d).type == "cuda" for d in devices):
        return_freed_buffers()
    replicas = [
        _replica(cfg, tokenizer, region_spec, model if i == 0 else copy.deepcopy(model),
                 torch.device(d), compute_dtype, wire, own_stream=mesh is not None)
        for i, d in enumerate(devices)
    ]

    @torch.inference_mode()
    def decode_fn(windows: np.ndarray) -> list[str]:
        shards = [windows] if mesh is None else [
            s["windows"] for s in split_batch(mesh, {"windows": windows})]
        # every shard is enqueued before any is read back
        done = [run(shard) for run, shard in zip(replicas, shards)]
        ids = np.concatenate([read() for read in done])
        return [t.strip() for t in tokenizer.batch_decode(ids)]

    return decode_fn


def _replica(cfg: Config, tokenizer, region_spec, model: EEGDecodingModel, device,
             compute_dtype, wire, *, own_stream: bool):
    """``run(windows) -> read``: enqueues the preprocess and beam search of
    one model replica on ``device`` (on a card with ``own_stream``, on the
    replica's own stream) and returns the function that waits for the ids
    and reads them back as numpy."""
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

    stream = torch.cuda.Stream(device) if own_stream and device.type == "cuda" else None

    def run(windows: np.ndarray):
        if stream is not None:
            # the weights and any earlier work are the default stream's
            stream.wait_stream(torch.cuda.current_stream(device))
        with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
            # a half-precision wire is cast up before the (f32-sensitive) IIR;
            # a read-only batch (a decode worker's pipe buffer) is copied first
            raw = torch.from_numpy(np.require(windows, wire, "W")).to(device).float()
            clean = frontend.preprocess(raw)
            stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
            stacked = torch.where(mask[None, :, :, None], stacked, 0.0)
            if compute_dtype is not None:
                stacked = stacked.to(compute_dtype)
            ids = generate(stacked, mask)

        def read() -> np.ndarray:
            if stream is not None:
                torch.cuda.current_stream(device).wait_stream(stream)
            return ids.cpu().numpy()

        return read

    return run


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
    devices: list[str] | None = None,
):
    """Build and warm the serving ``decode_fn`` from plain (picklable)
    arguments, so the whole build can run in the server process or inside
    a ``runtime.worker.DecodeWorker`` child, which then owns the card.

    Without ``checkpoint``, or with ``random_init``, the weights are random
    from seed 0 (smoke mode).  ``device="cuda"`` without a card raises.
    ``data_parallel > 1`` serves one replica on each of that many cards
    (raises without them; CPU replicas with ``device="cpu"``), or on the
    ``devices`` given (repeats allowed, e.g. two replicas on one card)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) to serve on the CPU")
    enable_persistent_cache()
    mesh = None
    if data_parallel > 1 or devices is not None:
        if devices is None:
            if device.type == "cuda" and torch.cuda.device_count() < data_parallel:
                raise RuntimeError(f"--data-parallel {data_parallel} needs {data_parallel} "
                                   f"cards, {torch.cuda.device_count()} found")
            devices = [torch.device(device.type, i) if device.type == "cuda" else device
                       for i in range(data_parallel)]
        elif data_parallel > 1 and len(devices) != data_parallel:
            raise ValueError(f"data_parallel={data_parallel} with {len(devices)} devices")
        mesh = make_mesh(len(devices), 1, devices=devices)
        device = mesh.devices[0]
        logger.info("decode mesh: %d replicas on %s", len(devices),
                    ", ".join(map(str, mesh.devices)))
    cfg, tokenizer, spec = serving_context(config, vocab, montage)
    T = cfg.data.n_timepoints
    model = build_model(cfg.model, T, seed=0, device=device)
    if checkpoint and not random_init:
        model.load_state_dict(load_serving_state_dict(checkpoint))
        logger.info("loaded checkpoint %s", checkpoint)
    else:
        logger.warning("serving with random weights (smoke mode)")
    decode_fn = build_decode_fn(
        cfg, tokenizer, spec, model, device=None if mesh is not None else device, mesh=mesh,
        compute_dtype=getattr(torch, compute_dtype) if compute_dtype else None,
        transfer_dtype=np.dtype(transfer_dtype) if transfer_dtype else None,
    )
    n_ch = int(spec.gather_indices.max() + 1)
    logger.info("warming up the decode function...")
    n_shards = 1 if mesh is None else mesh.n_batch_shards
    decode_fn(np.zeros((n_shards * -(-max(1, max_batch) // n_shards), n_ch, T), np.float32))
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
        help="split each decode batch over one model replica on each of this many "
        "cards (0 = one device; CPU replicas with --device cpu); --max-batch must "
        "be a multiple of it",
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
    if args.data_parallel > 1 and args.max_batch % args.data_parallel:
        ap.error(f"--max-batch {args.max_batch} is not a multiple of --data-parallel "
                 f"{args.data_parallel}")

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
