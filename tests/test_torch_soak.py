"""The port's streaming soak (``cli/streaming_soak.py``) on the CPU.

Short (seconds-scale) soaks of both service builders, as
``tests/test_soak_tool.py`` runs the JAX tool's:

* the tiny service, pooled, through each transport: ``inproc`` (the frames
  through ``WssService``'s handlers in process) and ``websocket`` (a
  localhost server; skipped without the ``websockets`` module);
* the full-size builder (``cli.serve.build_decode_fn``: BatchNorm folded,
  bf16) with a tiny config injected, in process and in a ``DecodeWorker``
  child, after which this process has not initialized CUDA;
* the in-process connection's order and backpressure;
* the serving processes' memory policy (``utils/memory.py``), in a child
  process: a freed mapped block no longer lets the next large one come
  from the heap;
* ``--isolate-clients`` under ``inproc``, and ``websocket`` without the
  module, raise; ``main`` passes its flags to ``soak`` (the report under
  ``--out``, by default under ``build/``) and exits with the report's
  ``ok``.

Every report carries every key of the JAX tool's report, read from one
short JAX soak of its tiny CPU service (``jax_keys``).
"""

import asyncio
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import streaming_soak
from tests.helpers import tiny_config, tiny_tokenizer
from tests.test_torch_models import few_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny_cfg():
    """The JAX soak test's injected config, as the port's."""
    cfg = tiny_config(tiny_tokenizer().vocab_size)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, bart=dataclasses.replace(
            cfg.model.bart, encoder_layers=1, decoder_layers=1)),
        generation=dataclasses.replace(cfg.generation, num_beams=1, max_length=6),
    )
    return config.Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The keys of the JAX tool's report, from one short soak of its tiny
    CPU service through its websocket (the key set does not depend on the
    duration)."""
    pytest.importorskip("websockets")
    sys.path.insert(0, str(REPO))
    from tools.streaming_soak import soak

    report = asyncio.run(soak(0.05, tmp_path_factory.mktemp("jax_soak"), _free_port(),
                              sessions=2, pooled=True))
    assert report["ok"], report
    return set(report)


def _soak(tmp_path, minutes, **kw):
    return asyncio.run(streaming_soak.soak(minutes, Path(tmp_path), _free_port(),
                                           device="cpu", **kw))


@pytest.mark.parametrize("transport", ["inproc", "websocket"])
def test_pooled_soak_short(tmp_path, jax_keys, transport):
    if transport == "websocket":
        pytest.importorskip("websockets")
    report = _soak(tmp_path, 0.15, sessions=2, pooled=True, transport=transport)
    assert report["ok"], report
    assert report["errors"] == 0 and report["utterances"] > 0
    assert report["pipeline_latency"]["batches"] > 0
    assert report["transport"] == transport
    assert jax_keys <= set(report), jax_keys - set(report)
    saved = json.loads((tmp_path / "soak_report.json").read_text())
    assert saved["utterances"] == report["utterances"]


def test_full_size_soak_short(tmp_path, jax_keys):
    """The --full-size builder (cli/serve.build_decode_fn: BN fold + bf16)
    serves utterances through the pooled scheduler end to end."""
    report = _soak(tmp_path, 0.05, sessions=2, pooled=True, full_size=True, max_batch=4,
                   cfg=_tiny_cfg(), transport="inproc")
    assert report["ok"], report
    assert report["full_size"] is True
    assert report["errors"] == 0 and report["utterances"] > 0
    assert report["pipeline_latency"]["mean_fill"] >= 1.0
    assert report["latency_stable"] in (True, False)
    assert report["rss_bounded"] in (True, False)
    # every pooled launch moved one padded (max_batch, C, W) float32 batch
    batches = report["pipeline_latency"]["batches"]
    assert report["h2d_total_mb"] == round(batches * 4 * 125 * 64 * 4 / 2**20, 1)
    assert jax_keys <= set(report), jax_keys - set(report)


def test_full_size_soak_with_decode_worker(tmp_path, jax_keys):
    """--decode-worker-budget-mb: the decode function runs in a recycled
    CHILD process (runtime/worker.py) and still serves utterances through
    the pooled scheduler; the report carries the worker's stats and the
    child's RSS, and this process never initialized CUDA."""
    report = _soak(tmp_path, 0.05, sessions=2, pooled=True, full_size=True, max_batch=4,
                   cfg=_tiny_cfg(), transport="inproc",
                   worker_budget_mb=1e6)  # no recycle inside a seconds-scale run
    assert report["ok"], report
    assert report["errors"] == 0 and report["utterances"] > 0
    assert report["decode_worker"]["calls"] > 0
    assert report["decode_worker"]["recycles"] == 0
    assert report["child_rss_max_mb"] and report["child_rss_max_mb"] > 0
    assert jax_keys <= set(report), jax_keys - set(report)
    assert not torch.cuda.is_initialized()


def test_inproc_connection_holds_back_a_sender_beyond_max_queue():
    """The in-process connection keeps a websocket's order and its
    backpressure: a server end that has stopped reading holds the sender
    back once MAX_QUEUE messages wait, then takes them all, in order."""
    n = streaming_soak.MAX_QUEUE

    async def run():
        reading, got = asyncio.Event(), []

        async def handler(ws):
            await reading.wait()
            async for message in ws:
                got.append(message)
                await ws.send(f"echo {message}")

        async with streaming_soak.inproc_connect(handler) as ws:
            for i in range(n):
                await ws.send(i)
            held = asyncio.create_task(ws.send(n))
            await asyncio.sleep(0.05)
            was_held = not held.done()
            reading.set()
            await held
            replies = [await ws.recv() for _ in range(n + 1)]
        return was_held, got, replies

    was_held, got, replies = asyncio.run(run())
    assert was_held
    assert got == list(range(n + 1))
    assert replies == [f"echo {i}" for i in range(n + 1)]


MALLOC_PROBE = """
import ctypes, sys
from imagined_speech_translation_tpu_torch.utils.memory import return_freed_buffers
class Info(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in ("arena", "ordblks", "smblks", "hblks",
                "hblkhd", "usmblks", "fsmblks", "uordblks", "fordblks", "keepcost")]
libc = ctypes.CDLL(None)
libc.mallinfo2.restype = Info
libc.malloc.restype, libc.malloc.argtypes = ctypes.c_void_p, [ctypes.c_size_t]
libc.free.argtypes = [ctypes.c_void_p]
if sys.argv[1] == "pinned":
    assert return_freed_buffers()
libc.free(libc.malloc(4 << 20))  # a mapped 4 MiB block, freed
before = libc.mallinfo2().hblkhd
block = libc.malloc(1 << 20)
print(libc.mallinfo2().hblkhd - before)  # bytes mapped for the 1 MiB block
"""


@pytest.mark.parametrize("policy, mapped", [("default", False), ("pinned", True)])
def test_serving_memory_policy_maps_large_blocks(policy, mapped):
    out = subprocess.run([sys.executable, "-c", MALLOC_PROBE, policy], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert (int(out.stdout) >= 1 << 20) is mapped


def test_isolate_clients_needs_a_process_transport(tmp_path):
    with pytest.raises(ValueError, match="--transport websocket"):
        _soak(tmp_path, 0.1, isolate_clients=True, transport="inproc")


def test_websocket_without_the_module_names_inproc(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "websockets", None)  # the card's machine has none
    with pytest.raises(RuntimeError, match="--transport inproc"):
        _soak(tmp_path, 0.1, transport="websocket")


def test_main_passes_its_flags_and_defaults_under_build(tmp_path, capsys, monkeypatch):
    args = streaming_soak.parser().parse_args([])
    assert Path(args.out) == REPO / "build" / "soak"
    assert (args.transport, args.device) == ("websocket", "cuda")
    seen = {}

    async def soak(minutes, out_dir, port, **kw):
        seen.update(minutes=minutes, out_dir=out_dir, **kw)
        return {"ok": False, "rss_series": [], "utterances": 0}

    monkeypatch.setattr(streaming_soak, "soak", soak)
    rc = streaming_soak.main(["--minutes", "0.05", "--sessions", "2", "--pooled",
                              "--transport", "inproc", "--device", "cpu",
                              "--transfer-dtype", "float16", "--out", str(tmp_path)])
    assert rc == 1  # the report's ok, as the exit code
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"ok": False, "utterances": 0}  # the series left out
    assert seen["out_dir"] == tmp_path and seen["minutes"] == 0.05
    assert (seen["transport"], seen["device"], seen["sessions"]) == ("inproc", "cpu", 2)
    assert seen["pooled"] and seen["transfer_dtype"] is np.float16
