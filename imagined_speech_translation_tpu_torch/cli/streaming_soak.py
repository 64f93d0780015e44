"""Streaming-server soak: hours of synthetic device EEG through the REAL
serving service, recording memory and latency stability.

Port of ``tools/streaming_soak.py``.  What runs: a ``WssService`` (the class
``cli/serve.py`` deploys) with a real decode pipeline on ``--device`` (the
card by default), and one client task a session that streams binary
``eeg`` frames continuously (utterance boundaries by ``eeg_end``) plus
periodic text commands, for ``--minutes``.  Every 10 s the RSS is sampled.

``--transport websocket`` (the default, as in the JAX tool) serves on a
localhost websocket and connects through it; it needs the ``websockets``
module and raises without it, naming ``--transport inproc``.  ``--transport
inproc`` passes the same frames (``runtime.protocol``'s ``encode_binary_frame``
and ``encode_text_frame``) to the same handler, ``WssService.handle_text`` /
``handle_binary`` on the server's event loop, through a pair of in-memory
queues a connection: each connection's messages are handled in order by a
task of its own, as a websocket connection's are.  Toward the server at
most :data:`MAX_QUEUE` messages wait (the ``websockets`` default
``max_queue``); a sender that finds them all waiting waits too, as a
websocket client does once the server stops reading, so a session that
sends faster than its decodes return is held back, not buffered without
bound.  ``--isolate-clients`` needs a transport between processes and
raises under ``inproc``.

Pass criteria (in the report; rc 1 on violation):

* zero protocol / stream errors, and at least one utterance;
* bounded memory: the linear fit of the RSS over the second half rises
  less than ``--rss-budget-mb-per-h`` (32 MB/h);
* stable latency: the second half's p95 at most 3x the first half's.

``--decode-worker-budget-mb > 0`` runs the decode function in a
``runtime.worker.DecodeWorker`` child (start method ``spawn``), which then
owns the card: the server process touches no CUDA.

Usage::

    python -m imagined_speech_translation_tpu_torch.cli.streaming_soak \\
        --minutes 120 --full-size --pooled --sessions 6 --max-batch 16 \\
        --transfer-dtype float16 --transport inproc [--device cpu]

The report goes to ``<--out>/soak_report.json`` (default ``build/soak``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import functools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TRANSPORTS = ("websocket", "inproc")
#: messages that may wait for an in-process connection's server end
MAX_QUEUE = 16


def _rss_mb() -> float:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS"):
            return int(line.split()[1]) / 1024.0
    return float("nan")


def _full_size_ctx(cfg=None):
    """Host-only context (no device touched): cfg, region spec, channel
    count, tokenizer."""
    import tempfile

    from ..config import default_config
    from ..data import ChineseCharTokenizer, RegionSpec
    from ..data.synthetic import make_synthetic_montage

    if cfg is None:
        cfg = default_config().validate()
    with tempfile.TemporaryDirectory() as td:
        labels = make_synthetic_montage(Path(td) / "montage.csv")
    spec = RegionSpec.from_channel_names(labels)
    n_channels = int(spec.gather_indices.max()) + 1
    # a synthetic vocabulary at the real size: the ids of the specials are
    # the data contract's, the surface forms do not matter for timing
    base = (
        ["[PAD]"]
        + [f"[unused{i}]" for i in range(99)]
        + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    )
    vocab = base + [f"[w{i}]" for i in range(cfg.model.bart.vocab_size - len(base))]
    return cfg, spec, n_channels, ChineseCharTokenizer(vocab)


def full_size_decode_factory(max_batch: int, cfg=None, transfer_dtype=None,
                             device: str = "cuda"):
    """Build and WARM the served full-size ``decode_fn`` (BatchNorm folded,
    bf16) on ``device``.

    Module-level with picklable arguments, so it can run inside a
    ``runtime.worker.DecodeWorker`` child, the process that then owns the
    card.  Random weights from seed 0: decode timing does not depend on
    them, and the program is the one ``cli.serve --max-batch 16
    --compute-dtype bfloat16`` deploys."""
    import torch

    from ..models import build_model
    from .serve import build_decode_fn

    cfg, spec, n_channels, tok = _full_size_ctx(cfg)
    window = cfg.data.n_timepoints
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) to soak on the CPU")
    model = build_model(cfg.model, window, seed=0, device=device)
    decode_fn = build_decode_fn(cfg, tok, spec, model, device=device,
                                compute_dtype=torch.bfloat16, transfer_dtype=transfer_dtype)
    print("device:", device, "window:", window, flush=True)
    t0 = time.time()
    decode_fn(np.zeros((max_batch, n_channels, window), np.float32))
    print(f"warmup: {time.time() - t0:.1f}s", flush=True)
    return decode_fn


def _pipeline_factory(decode_fn, scheduler, n_channels: int, window: int, max_batch: int):
    from ..runtime import (
        BatchingDecodePipeline,
        DecodePipeline,
        RingBuffer,
        ThresholdWakeGate,
        Windower,
    )

    if scheduler is not None:
        def factory(key):
            rb = RingBuffer(n_channels, window * 8)
            return BatchingDecodePipeline(
                windower=Windower(rb, window=window, hop=window),
                scheduler=scheduler,
                wake_gate=ThresholdWakeGate(0.05),
            )
    else:
        def factory(key):
            rb = RingBuffer(n_channels, window * 8)
            return DecodePipeline(
                windower=Windower(rb, window=window, hop=window),
                decode_fn=decode_fn,
                wake_gate=ThresholdWakeGate(0.05),
                max_batch=max_batch,
            )
    return factory


def _soak_service(decode_fn, pooled: bool, n_channels: int, window: int, max_batch: int):
    """``(WssService, scheduler or None)``: the pipelines of ``decode_fn``
    and a ``speak`` command."""
    from ..runtime import BatchScheduler, SessionRegistry
    from ..runtime.server import WssService

    scheduler = None
    if pooled:
        scheduler = BatchScheduler(decode_fn, max_batch=max_batch, max_delay_ms=25.0)
    reg = SessionRegistry()

    @reg.command("speak")
    async def speak(session, args):
        return {"spoken": args[0] if args else ""}

    svc = WssService(reg, pipeline_factory=_pipeline_factory(
        decode_fn, scheduler, n_channels, window, max_batch), n_channels=n_channels)
    return svc, scheduler


def build_full_size_service(pooled: bool, max_batch: int, cfg=None, transfer_dtype=None,
                            worker_budget_mb: float = 0.0, device: str = "cuda"):
    """``WssService`` over the SERVED path at full size on ``device``:
    ``cli/serve.build_decode_fn`` with the default config, BatchNorm folded
    and bf16, as ``cli/serve --max-batch 16 --compute-dtype bfloat16``
    deploys it.

    ``cfg`` overrides the model config (tests inject tiny widths; the real
    soak uses ``default_config()``).  ``worker_budget_mb > 0`` runs the
    decode function in a recycled child process (``runtime/worker.py``,
    ``cli/serve --decode-worker-budget-mb``), so the SERVER process never
    touches the card.

    Returns (service, registry, scheduler, window_length, n_channels,
    worker-or-None)."""
    cfg, _, n_channels, _ = _full_size_ctx(cfg)
    window = cfg.data.n_timepoints
    worker = None
    factory = functools.partial(full_size_decode_factory, max_batch, cfg, transfer_dtype,
                                device)
    if worker_budget_mb > 0:
        from ..runtime.worker import DecodeWorker

        # the soak pays one spawn for the whole run: a cold child builds the
        # kernels before its first decode, so wait for it generously
        worker = DecodeWorker(factory, rss_budget_mb=worker_budget_mb, start_timeout_s=1800.0)
        worker.start()
        decode_fn = worker
    else:
        decode_fn = factory()
    svc, scheduler = _soak_service(decode_fn, pooled, n_channels, window, max_batch)
    return svc, svc.registry, scheduler, window, n_channels, worker


def tiny_config(window: int):
    """The tiny service's config (the JAX tool's ``build_service`` widths)."""
    from ..config import (
        BartConfig,
        BrainEncoderConfig,
        Config,
        DataConfig,
        ModelConfig,
        RegionEncoderConfig,
    )

    h = 48
    return Config(
        data=DataConfig(n_timepoints=window, max_length=8),
        model=ModelConfig(
            hidden_dim=h,
            max_region_channels=16,
            region_channel_counts=(16, 9, 11, 12),
            brain_encoder=BrainEncoderConfig(
                hidden_dim=h, fusion_heads=4, cross_region_heads=4,
                region_encoder=RegionEncoderConfig(
                    conv_channels=(8, 16, 24, 32, 48),
                    attn_heads=(4, 2, 2), se_reduction=4,
                ),
            ),
            bart=BartConfig(
                vocab_size=128, d_model=h, encoder_layers=3, decoder_layers=2,
                num_heads=4, ffn_dim=96, max_position_embeddings=32,
            ),
        ),
    ).validate()


def build_service(n_channels: int, window: int, pooled: bool = False, device: str = "cuda"):
    """``WssService`` with a REAL tiny-model decode pipeline on ``device``
    (random weights from seed 0, greedy search to length 8).

    ``pooled=True`` routes every session through one shared
    ``BatchScheduler`` (``runtime/batcher.py``) instead of batching a
    session's windows in its own ``DecodePipeline``: the multi-tenant
    configuration of ``cli/serve --max-batch``.  Returns (service,
    registry, scheduler)."""
    import torch

    from ..decode import DecodeParams, build_generate_fn
    from ..models import build_model

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (--device cpu) to soak on the CPU")
    cfg = tiny_config(window)
    model = build_model(cfg.model, window, seed=0, device=device)
    mask = np.zeros((4, 16), bool)
    counts = cfg.model.region_channel_counts
    for r, c in enumerate(counts):
        mask[r, :c] = True
    offs = np.cumsum([0] + list(counts))
    gather = np.asarray([list(range(offs[r], offs[r + 1])) + [0] * (16 - counts[r])
                         for r in range(4)])
    channel_mask = torch.as_tensor(mask, device=device)
    dp = DecodeParams(
        max_length=8, min_length=2, num_beams=1,
        pad_token_id=cfg.model.bart.pad_token_id,
        eos_token_id=cfg.model.bart.eos_token_id,
        decoder_start_token_id=cfg.model.bart.decoder_start_token_id,
    )
    generate = build_generate_fn(model, dp)
    max_batch = 4

    def decode_fn(batch):  # (N, C=48, T)
        n = batch.shape[0]
        padded = np.zeros((max_batch, 48, batch.shape[2]), np.float32)
        padded[:n] = batch
        stacked = padded[:, gather.reshape(-1), :].reshape(max_batch, 4, 16, batch.shape[2])
        stacked = np.where(mask[None, :, :, None], stacked, 0.0)
        toks = generate(torch.as_tensor(stacked, device=device), channel_mask).cpu().numpy()
        return [" ".join(map(str, row[row > 0])) for row in toks[:n]]

    # warm the decode function before the clock starts: the first call on
    # the card builds the kernels and would otherwise be charged to the
    # soak's latency series
    decode_fn(np.zeros((1, 48, window), np.float32))
    svc, scheduler = _soak_service(decode_fn, pooled, n_channels, window, max_batch)
    return svc, svc.registry, scheduler


# ---------------------------------------------------------------------------
# the in-process transport
# ---------------------------------------------------------------------------


class InprocClosed(Exception):
    """The other end of an in-process connection has closed."""


class InprocSocket:
    """One end of an in-process connection: ``send``, ``recv`` and ``async
    for``, as a websocket's, over two queues; a message is ``str`` (a text
    frame) or ``bytes`` (a binary frame), passed as it is."""

    _CLOSE = object()

    def __init__(self, inbox: asyncio.Queue, outbox: asyncio.Queue):
        self._inbox, self._outbox = inbox, outbox
        self.closed = False

    async def send(self, message) -> None:
        """Queue ``message``; waits while the other end has a full queue."""
        if self.closed:
            raise InprocClosed("send on a closed connection")
        await self._outbox.put(message)

    async def recv(self):
        message = await self._inbox.get()
        if message is self._CLOSE:
            self.closed = True
            raise InprocClosed("the connection closed")
        return message

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self.recv()
        except InprocClosed:
            raise StopAsyncIteration from None

    async def close(self) -> None:
        """No more sends; the other end's iteration ends after what waits."""
        if not self.closed:
            self.closed = True
            await self._outbox.put(self._CLOSE)


@contextlib.asynccontextmanager
async def inproc_connect(handler):
    """A client end whose server end ``handler`` serves in a task of its
    own, as ``websockets.serve`` runs a connection's handler."""
    to_server, to_client = asyncio.Queue(maxsize=MAX_QUEUE), asyncio.Queue()
    client, server = InprocSocket(to_client, to_server), InprocSocket(to_server, to_client)
    task = asyncio.create_task(handler(server))
    try:
        yield client
    finally:
        # the server end handles what waits, then sees the close
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(client.close(), 60.0)
            await asyncio.wait_for(asyncio.shield(task), 60.0)
        if not task.done():
            task.cancel()
        await server.close()


def make_handler(svc):
    """The soak server's connection handler: binary frames through
    ``svc.handle_binary`` (each text back as an ``utterance`` frame, an
    exception as an ``error`` frame), text frames through
    ``svc.handle_text``."""
    from ..runtime.protocol import TextFrame, encode_text_frame

    closed: tuple = (InprocClosed,)
    with contextlib.suppress(ImportError):
        from websockets.exceptions import ConnectionClosed

        closed += (ConnectionClosed,)

    async def handler(ws):
        try:
            async for message in ws:
                if isinstance(message, bytes):
                    try:
                        texts = await svc.handle_binary(message)
                        for t in texts:
                            await ws.send(encode_text_frame(TextFrame("utterance", "", (t,))))
                    except closed:
                        raise
                    except Exception as e:  # noqa: BLE001 - counted, not fatal
                        await ws.send(encode_text_frame(TextFrame("error", "stream", (str(e),))))
                else:
                    await ws.send(await svc.handle_text(message))
        except closed:
            pass  # the client hung up mid-reply (drain): not a soak error

    return handler


def _websockets():
    try:
        import websockets
    except ImportError:
        raise RuntimeError("--transport websocket needs the websockets module, which is not "
                           "installed; pass --transport inproc to drive the service in "
                           "process") from None
    return websockets


def _connector(transport: str, port: int, handler=None):
    """``connect()``: an async context manager giving a client connection."""
    if transport == "inproc":
        return functools.partial(inproc_connect, handler)
    websockets = _websockets()
    # loopback soak: keepalive pings off -- a long first decode or a
    # co-tenant hogging the core must not read as a dead peer
    return functools.partial(websockets.connect, f"ws://127.0.0.1:{port}", max_size=None,
                             ping_interval=None, ping_timeout=None)


async def client_sessions(port: int, sessions: int, t_end: float, n_channels: int,
                          window: int, *, t0: float | None = None, transport: str = "websocket",
                          handler=None):
    """Drive ``sessions`` device connections against a running soak server
    until ``t_end``; returns (counters, latencies) with latencies as
    (elapsed-seconds, utterance-ms) pairs.  Runs in the server process or as
    the body of the isolated client process; ``transport="inproc"`` serves
    each connection with ``handler`` in this event loop."""
    from ..runtime.protocol import BinaryFrame, encode_binary_frame

    connect = _connector(transport, port, handler)
    t0 = time.time() if t0 is None else t0
    counters = {"frames_sent": 0, "utterances": 0, "errors": 0, "text_cmds": 0}
    latencies: list[tuple[float, float]] = []

    async def session_loop(s_idx: int):
        s_rng = np.random.default_rng(s_idx)
        async with connect() as ws:
            await ws.send(f"authentication¬soak-token-{s_idx}")
            reply = await ws.recv()
            key = json.loads(reply.split("¬")[2])
            last_end = [time.time()]

            async def reader():
                async for msg in ws:
                    if isinstance(msg, str):
                        if msg.startswith("utterance"):
                            counters["utterances"] += 1
                            latencies.append(
                                (time.time() - t0, (time.time() - last_end[0]) * 1e3))
                        elif msg.startswith("error"):
                            counters["errors"] += 1
                            if counters["errors"] < 5:
                                print("ERR:", msg[:200], flush=True)

            rtask = asyncio.create_task(reader())
            i = 0
            while time.time() < t_end:
                chunk = s_rng.normal(0, 1, (n_channels, window // 2)).astype(np.float32)
                await ws.send(encode_binary_frame(BinaryFrame("eeg", key, chunk.tobytes())))
                counters["frames_sent"] += 1
                i += 1
                if i % 16 == 0:  # an utterance boundary every 8 windows
                    last_end[0] = time.time()
                    await ws.send(encode_binary_frame(BinaryFrame("eeg_end", key, b"")))
                if i % 64 == 0:
                    await ws.send(f"speak¬{key}¬soak check {i}")
                    counters["text_cmds"] += 1
                # keep the AGGREGATE frame rate constant as sessions scale
                await asyncio.sleep(0.02 * sessions)
            # drain
            await ws.send(encode_binary_frame(BinaryFrame("eeg_end", key, b"")))
            await asyncio.sleep(1.0)
            rtask.cancel()

    await asyncio.gather(*(session_loop(i) for i in range(sessions)))
    return counters, latencies


def _client_main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--_client", action="store_true")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--sessions", type=int, required=True)
    ap.add_argument("--minutes", type=float, required=True)
    ap.add_argument("--channels", type=int, required=True)
    ap.add_argument("--window", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    counters, latencies = asyncio.run(client_sessions(
        a.port, a.sessions, time.time() + a.minutes * 60.0, a.channels, a.window))
    Path(a.out).write_text(json.dumps({"counters": counters, "latencies": latencies}))
    return 0


async def soak(
    minutes: float,
    out_dir: Path,
    port: int,
    sessions: int = 1,
    pooled: bool = False,
    full_size: bool = False,
    max_batch: int = 4,
    cfg=None,
    transfer_dtype=None,
    rss_budget_mb_per_h: float = 32.0,
    isolate_clients: bool = False,
    worker_budget_mb: float = 0.0,
    transport: str = "websocket",
    device: str = "cuda",
) -> dict:
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r}: one of {TRANSPORTS}")
    if isolate_clients and transport == "inproc":
        raise ValueError("--isolate-clients runs the clients in a process of their own, which "
                         "needs --transport websocket; inproc connections live in the "
                         "server's event loop")
    if transport == "websocket":
        websockets = _websockets()

    worker = None
    if full_size:
        svc, _, scheduler, window, n_channels, worker = build_full_size_service(
            pooled=pooled, max_batch=max_batch, cfg=cfg, transfer_dtype=transfer_dtype,
            worker_budget_mb=worker_budget_mb, device=device)
    else:
        n_channels, window = 48, 128
        svc, _, scheduler = build_service(n_channels, window, pooled=pooled, device=device)

    counters = {"frames_sent": 0, "utterances": 0, "errors": 0, "text_cmds": 0}
    latencies: list[tuple[float, float]] = []  # (t, ms)
    rss: list[tuple[float, float]] = []
    handler = make_handler(svc)

    t_end = time.time() + minutes * 60.0
    t0 = time.time()
    child_rss: list[tuple[float, float]] = []

    def _sample():
        rss.append((time.time() - t0, _rss_mb()))
        if worker is not None and worker._proc is not None:
            from ..runtime.worker import _rss_mb as _pid_rss

            child_rss.append((time.time() - t0, _pid_rss(worker._proc.pid)))

    async def rss_sampler():
        while time.time() < t_end:
            _sample()
            await asyncio.sleep(10.0)
        _sample()

    async def run_clients_here():
        c, lat = await client_sessions(port, sessions, t_end, n_channels, window, t0=t0,
                                       transport=transport, handler=handler)
        counters.update(c)
        latencies.extend(lat)

    async def run_clients_subproc():
        """Load generation in its OWN process: the client loops share
        neither the server's event loop nor its GIL, so utterance latency
        measures the SERVER, not client starvation (and matches the real
        topology, where devices are remote peers)."""
        import tempfile

        out = tempfile.NamedTemporaryFile(suffix=".json", delete=False)
        out.close()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", __spec__.name, "--_client",
            "--port", str(port), "--sessions", str(sessions),
            "--minutes", str(minutes), "--channels", str(n_channels),
            "--window", str(window), "--out", out.name, cwd=str(REPO),
        )
        rc = await proc.wait()
        if rc != 0:
            raise RuntimeError(f"client process failed rc={rc}")
        payload = json.loads(Path(out.name).read_text())
        os.unlink(out.name)
        counters.update(payload["counters"])
        latencies.extend(tuple(x) for x in payload["latencies"])

    run_clients = run_clients_subproc if isolate_clients else run_clients_here
    try:
        async with contextlib.AsyncExitStack() as stack:
            if transport == "websocket":
                await stack.enter_async_context(
                    websockets.serve(handler, "127.0.0.1", port, ping_interval=None))
            sampler = asyncio.create_task(rss_sampler())
            if scheduler is not None:
                async with scheduler:
                    await run_clients()
            else:
                await run_clients()
            sampler.cancel()
    except BaseException:
        if worker is not None:
            worker.stop()
        raise

    # ---- analysis ----------------------------------------------------
    dur_s = time.time() - t0
    lat_ms = [m for _, m in latencies]
    half = len(lat_ms) // 2 or 1

    def p95(xs):
        if not xs:
            return None
        s = sorted(xs)
        return s[min(len(s) - 1, int(0.95 * len(s)))]

    rss_half = [(t, m) for t, m in rss if t >= dur_s / 2]
    slope_mb_per_h = 0.0
    if len(rss_half) >= 3:
        ts = np.array([t for t, _ in rss_half])
        ms = np.array([m for _, m in rss_half])
        slope_mb_per_h = float(np.polyfit(ts, ms, 1)[0] * 3600.0)

    # host->device accounting: every pooled launch moves one padded
    # (max_batch, C, W) batch to the device; a transport that leaked per
    # transfer would show up as rss_growth ~= h2d_total, and the ratio
    # attributes it
    wire_bytes = 2 if transfer_dtype is not None else 4
    n_launches = scheduler.batches if scheduler is not None else None
    h2d_mb = (
        round(n_launches * max_batch * n_channels * window * wire_bytes / 2**20, 1)
        if n_launches is not None and full_size
        else None
    )
    report = {
        "duration_min": round(dur_s / 60.0, 1),
        **counters,
        "windows_per_utterance": 8,
        "latency_p50_ms": round(sorted(lat_ms)[len(lat_ms) // 2], 1) if lat_ms else None,
        "latency_p95_first_half_ms": p95(lat_ms[:half]),
        "latency_p95_second_half_ms": p95(lat_ms[half:]),
        "rss_start_mb": round(rss[0][1], 1) if rss else None,
        "rss_end_mb": round(rss[-1][1], 1) if rss else None,
        "rss_slope_second_half_mb_per_h": round(slope_mb_per_h, 2),
        "rss_budget_mb_per_h": rss_budget_mb_per_h,
        "h2d_total_mb": h2d_mb,
        "rss_growth_per_h2d_mb": (
            round((rss[-1][1] - rss[0][1]) / h2d_mb, 3) if h2d_mb and rss else None
        ),
        "rss_series": [(round(t, 1), round(m, 1)) for t, m in rss],
        "sessions": sessions,
        "pooled": pooled,
        "full_size": full_size,
        "window": window,
        "max_batch": max_batch if full_size else 4,
        "pipeline_latency": (
            scheduler.stats()
            if scheduler is not None
            else next(iter(svc._pipelines.values())).latency.summary()
            if svc._pipelines
            else None
        ),
        "decode_worker": worker.stats() if worker is not None else None,
        "child_rss_max_mb": round(max(m for _, m in child_rss), 1) if child_rss else None,
        "child_rss_series": [(round(t, 1), round(m, 1)) for t, m in child_rss] or None,
        "transport": transport,
        "device": device,
        "card": _card(device),
        "latency_p50_first_half_ms": _p50(lat_ms[:half]),
        "latency_p50_second_half_ms": _p50(lat_ms[half:]),
    }
    # derived verdicts: the pass claims are computed from the measurements
    # and surfaced by name
    report["latency_stable"] = bool(
        report["latency_p95_second_half_ms"] is None
        or report["latency_p95_first_half_ms"] is None
        or report["latency_p95_second_half_ms"]
        <= 3.0 * max(report["latency_p95_first_half_ms"], 1.0)
    )
    report["rss_bounded"] = bool(slope_mb_per_h < rss_budget_mb_per_h)
    report["ok"] = (
        counters["errors"] == 0
        and counters["utterances"] > 0
        and report["rss_bounded"]
        and report["latency_stable"]
    )
    if worker is not None:
        worker.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "soak_report.json").write_text(json.dumps(report, indent=2))
    return report


def _card(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit (``cpu`` on the CPU);
    reads no CUDA state, so a decode worker's parent stays without a
    context."""
    import torch

    from .profile_slice import card_line

    return card_line(torch.device(device))


def _p50(xs):
    return round(sorted(xs)[len(xs) // 2], 1) if xs else None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=120.0)
    ap.add_argument("--out", default=str(REPO / "build" / "soak"))
    ap.add_argument("--port", type=int, default=41414)
    ap.add_argument("--sessions", type=int, default=1)
    ap.add_argument("--pooled", action="store_true",
                    help="route all sessions through one shared BatchScheduler")
    ap.add_argument("--full-size", action="store_true",
                    help="serve the full-size model (default config, BN folded, bfloat16) "
                    "on --device: the card's serving soak")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="pooled/pipeline decode batch in --full-size mode")
    ap.add_argument("--transfer-dtype", default=None, choices=("float16",),
                    help="half-precision host->device wire for --full-size decode")
    ap.add_argument("--isolate-clients", action="store_true",
                    help="run the load-generating sessions in their own process so "
                    "utterance latency measures the server, not client starvation "
                    "(websocket transport only)")
    ap.add_argument("--rss-budget-mb-per-h", type=float, default=32.0,
                    help="RSS-slope pass budget; raise ONLY with an attributed "
                    "leak (see rss_growth_per_h2d_mb in the report)")
    ap.add_argument("--decode-worker-budget-mb", type=float, default=0.0,
                    help="full-size mode: run the decode function in a child process "
                    "recycled at this RSS (runtime/worker.py); the SERVER process then "
                    "touches no CUDA; 0 = in-process")
    ap.add_argument("--transport", choices=TRANSPORTS, default="websocket",
                    help="websocket (a localhost server, needs the websockets module) or "
                    "inproc (the same frames through WssService's handlers in process)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--_client" in argv:
        return _client_main(argv)
    ap = parser()
    args = ap.parse_args(argv)
    if args.device == "cuda" and args.decode_worker_budget_mb <= 0:
        # with a decode worker the child claims the card (and raises
        # without one): the server process touches no CUDA
        from .train import check_device

        check_device(args.device)
    report = asyncio.run(soak(
        args.minutes, Path(args.out), args.port,
        sessions=args.sessions, pooled=args.pooled,
        full_size=args.full_size, max_batch=args.max_batch,
        transfer_dtype=np.float16 if args.transfer_dtype else None,
        rss_budget_mb_per_h=args.rss_budget_mb_per_h,
        isolate_clients=args.isolate_clients,
        worker_budget_mb=args.decode_worker_budget_mb,
        transport=args.transport, device=args.device,
    ))
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("rss_series", "child_rss_series")}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
