"""The port's serving entry point (``cli/serve.py``) on the CPU.

(a) The port's websocket service as ``cli.serve.main`` wires it (the port's
    ``build_decode_fn`` on converted weights, ``--max-batch 4``, one
    ``BatchingDecodePipeline`` a session) against the JAX package's service
    wired as its ``main`` wires it, around the JAX composition of
    ``tests/test_torch_slice.py`` (the Pallas IIR in interpret mode, CAR,
    region gather, ``build_generate_fn``) on the same weights: three
    sessions stream frames of uneven sizes, then ``eeg_end``; the utterances
    and the decoded token ids must be identical, session by session and in
    order, and so must the batches of windows the two schedulers form.  (A
    model with random weights decodes nearly the same tokens whatever the
    window; ``tests/test_torch_runtime.py`` holds the routing of each window
    to its session with a decode function whose text names its row.)
(b) The float16 wire: windows already rounded to float16 decode to
    identical ids through the float16 and the float32 wire.
(c) ``--checkpoint`` with a checkpoint directory of the port's
    ``CheckpointManager`` and with a model ``state_dict`` file: the same ids
    as ``build_decode_fn`` on the saved model, loaded strictly.
(d) ``main``'s arguments: ``--data-parallel 2`` with a ``--max-batch`` that
    does not split over it, ``--data-parallel 2`` without two cards and
    ``--device cuda`` without a card fail; ``--device cpu`` serves
    (in-process, pooled, and in a ``DecodeWorker`` child).
(e) One real websocket round trip through ``cli.serve.main`` on a free
    port.

Sizes: ``tests.helpers.tiny_config`` at T = 124 (the region encoders'
128 tokens take the flash route), the synthetic 125-channel montage.
"""

import asyncio
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu.data import ChineseCharTokenizer as JaxTokenizer
from imagined_speech_translation_tpu.data.synthetic import make_synthetic_montage
from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams
from imagined_speech_translation_tpu.decode import build_generate_fn as jax_build_generate_fn
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu.models.folding import fold_batch_norm as jax_fold
from imagined_speech_translation_tpu.runtime import (
    BatchingDecodePipeline as JaxBatchingPipeline,
    BatchScheduler as JaxScheduler,
    RingBuffer as JaxRingBuffer,
    SessionRegistry as JaxRegistry,
    Windower as JaxWindower,
)
from imagined_speech_translation_tpu.runtime.commands import (
    build_command_registry as jax_command_registry,
)
from imagined_speech_translation_tpu.runtime.server import WssService as JaxService
from imagined_speech_translation_tpu.runtime.services import ServiceBundle as JaxBundle
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import serve
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, RegionSpec
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from imagined_speech_translation_tpu_torch.runtime.server import WssService
from imagined_speech_translation_tpu_torch.training import (
    CheckpointManager,
    FusedAdamW,
    build_train_module,
    create_train_state,
)
from tests.helpers import TINY_VOCAB, tiny_config
from tests.test_torch_models import seeded_flax_variables

T = 124
VOCAB = list(dict.fromkeys(TINY_VOCAB))
FRAMES = (37, 124, 61, 90, 13, 200, 3)  # samples a frame, in turn


def recording(tokenizer_cls):
    """``tokenizer_cls`` keeping every id batch it decodes, in order."""
    class Recording(tokenizer_cls):
        def batch_decode(self, batch_ids, **kw):
            self.history = getattr(self, "history", []) + [np.asarray(batch_ids)]
            return super().batch_decode(batch_ids, **kw)

    return Recording


RecordingTokenizer = recording(ChineseCharTokenizer)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jcfg = tiny_config(len(VOCAB), n_timepoints=T)
    cfg = config.Config.from_json(jcfg.to_json())
    (root / "cfg.json").write_text(cfg.to_json())
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    labels = make_synthetic_montage(root / "montage.csv")
    spec = RegionSpec.from_channel_names(labels)
    variables = seeded_flax_variables(
        JaxModel(jcfg.model), np.zeros((1, 4, 16, T), np.float32), np.zeros((1, 4), np.int32),
        spec.channel_mask, seed=1)
    model = load_flax_variables(EEGDecodingModel(cfg.model, T).eval(), variables)
    return dict(root=root, jcfg=jcfg, cfg=cfg, spec=spec, n_ch=len(labels),
                variables=variables, model=model)


def _tokenizer(cls=RecordingTokenizer):
    return cls(VOCAB, eos_token="[EOS]")


def jax_decode_fn(s, tok):
    """The JAX package's serving computation on the same weights (BN folded),
    as ``tests/test_torch_slice.py`` composes it, jitted once."""
    jcfg, spec = s["jcfg"], s["spec"]
    g = jcfg.generation
    generate = jax_build_generate_fn(JaxModel(jcfg.model), JaxDecodeParams(
        max_length=g.max_length, min_length=g.min_length, num_beams=g.num_beams,
        pad_token_id=tok.pad_token_id, eos_token_id=tok.sep_token_id,
        decoder_start_token_id=tok.bos_token_id), jit=False)
    fe = JaxFrontend(jcfg.frontend)
    gather, mask = jnp.asarray(spec.gather_indices.reshape(-1)), jnp.asarray(spec.channel_mask)
    R, C = spec.channel_mask.shape

    @jax.jit
    def run(variables, raw):
        clean = jax_car(sosfilt_pallas([fe.sos_bandpass, fe.sos_notch], raw, interpret=True))
        stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
        stacked = jnp.where(mask[None, :, :, None], stacked, 0.0)
        return generate(variables, stacked, mask)

    variables = jax_fold(s["variables"])

    def decode_fn(windows):
        tokens = np.asarray(run(variables, jnp.asarray(windows, jnp.float32)))
        return [t.strip() for t in tok.batch_decode(tokens)]

    return decode_fn


def jax_service(decode_fn, n_ch):
    """The JAX service wired as the JAX ``cli/serve.py main`` wires it."""
    scheduler = JaxScheduler(decode_fn, max_batch=4, max_delay_ms=20)
    registry = jax_command_registry(JaxBundle(), registry=JaxRegistry())
    svc = JaxService(registry, n_channels=n_ch, pipeline_factory=lambda key: JaxBatchingPipeline(
        windower=JaxWindower(JaxRingBuffer(n_ch, capacity=4 * T), window=T, hop=T),
        scheduler=scheduler))
    return svc, scheduler


def recorded(decode_fn, batches):
    """``decode_fn``, keeping a copy of every batch it is handed."""
    def call(batch):
        batches.append(np.array(batch))
        return decode_fn(batch)

    return call


def stream_sessions(svc, scheduler, eeg):
    """Each session authenticates, streams its ``(n_ch, n)`` samples in
    frames of ``FRAMES`` sizes, then ``eeg_end``; the sessions run
    concurrently.  Returns each session's utterances in order."""
    async def session(i, samples):
        key = json.loads((await svc.handle_text(f"authentication¬user{i}")).split("¬")[2])
        out, start, k = [], 0, i
        while start < samples.shape[1]:
            n = FRAMES[k % len(FRAMES)]
            frame = np.ascontiguousarray(samples[:, start:start + n])
            out += await svc.handle_binary(b"eeg|" + key.encode() + b"|" + frame.tobytes())
            start, k = start + n, k + 1
        return out + await svc.handle_binary(b"eeg_end|" + key.encode() + b"|")

    async def run():
        async with scheduler:
            return await asyncio.gather(*(session(i, x) for i, x in enumerate(eeg)))

    return asyncio.run(run())


def test_service_matches_the_jax_service(setup):
    s = setup
    n_ch = s["n_ch"]
    # 3 sessions of 2, 3 and 1 windows (and a tail shorter than a window)
    lengths = (2 * T + 50, 3 * T, T + 7)
    rng = np.random.default_rng(5)
    eeg = [(rng.normal(size=(n_ch, n)) * 20.0).astype(np.float32) for n in lengths]

    jtok, jbatches = _tokenizer(recording(JaxTokenizer)), []
    jdec = jax_decode_fn(s, jtok)
    jdec(np.zeros((4, n_ch, T), np.float32))  # compile before the deadline clock runs
    jtok.history = []
    want = stream_sessions(*jax_service(recorded(jdec, jbatches), n_ch), eeg)

    tok, batches = _tokenizer(), []
    decode_fn = serve.build_decode_fn(s["cfg"], tok, s["spec"], s["model"], device="cpu")
    svc, scheduler = serve.build_service(recorded(decode_fn, batches), n_channels=n_ch,
                                         window=T, max_batch=4, max_delay_ms=20)
    got = stream_sessions(svc, scheduler, eeg)

    assert [len(u) for u in got] == [2, 3, 1]
    assert got == want
    # the same windows in the same (padded) batches, decoded to the same ids
    assert len(batches) == len(jbatches) == scheduler.batches
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a, b)
    assert len(tok.history) == len(jtok.history) == scheduler.batches
    for a, b in zip(tok.history, jtok.history):
        np.testing.assert_array_equal(a, b)
    ids = np.concatenate(tok.history)
    assert ids.shape[1] > 1 and (ids[:, 1:] != tok.pad_token_id).any()


def test_float16_wire_decodes_the_same_ids(setup, monkeypatch):
    s = setup
    windows = (np.random.default_rng(6).normal(size=(3, s["n_ch"], T)) * 20.0)
    windows = windows.astype(np.float16).astype(np.float32)  # exact in float16
    wires = []
    from_numpy = torch.from_numpy

    def spy(a):
        wires.append(a.dtype)
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", spy)
    ids = {}
    for wire in (None, np.float16):
        tok = _tokenizer()
        serve.build_decode_fn(s["cfg"], tok, s["spec"], s["model"], device="cpu",
                              transfer_dtype=wire)(windows)
        ids[wire] = tok.history[-1]
    assert wires == [np.float32, np.float16]
    np.testing.assert_array_equal(ids[None], ids[np.float16])


def _args(root, **kw):
    return dict(vocab=str(root / "vocab.txt"), montage=str(root / "montage.csv"),
                config=str(root / "cfg.json"), device="cpu", **kw)


def test_checkpoint_forms_load_strictly(setup, tmp_path, monkeypatch):
    s = setup
    cfg = s["cfg"]
    module = build_train_module(cfg, bow_k=8, seed=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    for name, buf in module.model.named_buffers():  # BatchNorm statistics of a trained model
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.3)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    state = create_train_state(module, FusedAdamW([n for n, _ in module.named_parameters()],
                                                  cfg.training.optimizer, 10),
                               {"loss_ce": 1.0, "loss_bow": 0.5})
    ckpt = CheckpointManager(tmp_path / "ckpt")
    ckpt.save_epoch(state, 0, {"epoch": 0})
    plain = tmp_path / "model.pt"
    torch.save(module.model.state_dict(), plain)

    want_state = module.model.state_dict()
    for form in (tmp_path / "ckpt" / "checkpoint_epoch_1", plain):
        got = serve.load_serving_state_dict(form)
        assert set(got) == set(want_state)
        assert all(torch.equal(got[k], want_state[k]) for k in want_state)

    windows = (np.random.default_rng(7).normal(size=(2, s["n_ch"], T)) * 20.0).astype(np.float32)
    tok = _tokenizer()
    serve.build_decode_fn(cfg, tok, s["spec"], module.model.eval(), device="cpu")(windows)
    want = tok.history[-1]
    toks = []
    monkeypatch.setattr(serve, "ChineseCharTokenizer", type("T", (RecordingTokenizer,), {
        "from_vocab_file": classmethod(lambda cls, p: toks.append(_tokenizer()) or toks[-1])}))
    for form in (tmp_path / "ckpt" / "checkpoint_epoch_1", plain):
        decode_fn = serve.build_decode_fn_from_args(**_args(s["root"], checkpoint=str(form)))
        decode_fn(windows)
        np.testing.assert_array_equal(toks[-1].history[-1], want)

    # strict: an extra entry, and a checkpoint of another model, refuse to load
    bad = dict(module.model.state_dict(), extra=torch.zeros(1))
    torch.save(bad, tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        serve.build_decode_fn_from_args(**_args(s["root"], checkpoint=str(tmp_path / "extra.pt")))
    other = config.replace_nested(cfg, "model.bart.ffn_dim", 64)
    torch.save(build_train_module(other, bow_k=8, seed=0, device="cpu").model.state_dict(),
               tmp_path / "other.pt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        serve.build_decode_fn_from_args(**_args(s["root"], checkpoint=str(tmp_path / "other.pt")))


def _main_argv(root, *extra):
    return ["--vocab", str(root / "vocab.txt"), "--montage", str(root / "montage.csv"),
            "--config", str(root / "cfg.json"), "--random-init", *extra]


def test_main_refuses_data_parallel_and_a_missing_card(setup, monkeypatch, capsys):
    root = setup["root"]
    with pytest.raises(SystemExit):
        serve.main(_main_argv(root, "--device", "cpu", "--data-parallel", "2"))
    assert "--max-batch 1 is not a multiple of --data-parallel 2" in capsys.readouterr().err
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="--data-parallel 2 needs 2 cards"):
            serve.build_decode_fn_from_args(**dict(_args(root, data_parallel=2), device="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        serve.main(_main_argv(root))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.build_decode_fn_from_args(**dict(_args(root), device="cuda"))


@pytest.mark.parametrize("extra", [
    ("--max-batch", "1"), ("--max-batch", "4", "--max-delay-ms", "5"),
    ("--max-batch", "2", "--decode-worker-budget-mb", "100000"),
], ids=["in_process", "pooled", "decode_worker"])
def test_main_serves_on_the_cpu(setup, monkeypatch, extra):
    """``main`` with ``--device cpu``: ``WssService.serve`` is replaced by a
    client that authenticates, streams two windows and asks for ``latency``."""
    n_ch = setup["n_ch"]
    seen = {}

    async def fake_serve(self, host, port):
        key = json.loads((await self.handle_text("authentication¬tok")).split("¬")[2])
        eeg = np.random.default_rng(8).normal(size=(n_ch, 2 * T)).astype(np.float32)
        texts = []
        for part in (eeg[:, :150], eeg[:, 150:]):
            texts += await self.handle_binary(b"eeg|" + key.encode() + b"|" + part.tobytes())
        seen.update(texts=texts, host=host, port=port,
                    latency=await self.handle_text(f"latency¬{key}"))

    monkeypatch.setattr(WssService, "serve", fake_serve)
    serve.main(_main_argv(setup["root"], "--device", "cpu", "--port", "4999", *extra))
    assert (seen["host"], seen["port"]) == ("127.0.0.1", 4999)
    assert len(seen["texts"]) == 2 and all(isinstance(t, str) for t in seen["texts"])
    command, name, body = seen["latency"].split("¬")
    stats = json.loads(body)
    assert (command, name) == ("ok", "latency")
    if extra[1] == "1":
        assert [v["count"] for v in stats.values()] == [2]
    else:
        assert stats["pooled"]["count"] == 2 and stats["pooled"]["batches"] >= 1
    assert ("decode_worker" in stats) == ("--decode-worker-budget-mb" in extra)
    if "decode_worker" in stats:
        assert stats["decode_worker"]["calls"] == stats["pooled"]["batches"]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_websocket_round_trip(setup, monkeypatch):
    """``cli.serve.main`` in a thread on a free port; a websocket client
    authenticates, sends one window as two ``eeg`` frames and gets its
    ``utterance`` frame back."""
    websockets = pytest.importorskip("websockets")
    root, n_ch = setup["root"], setup["n_ch"]
    port = _free_port()
    running, errors = {}, []
    serve_forever = WssService.serve

    async def recording_serve(self, host, port):
        running["loop"], running["task"] = asyncio.get_running_loop(), asyncio.current_task()
        await serve_forever(self, host, port)

    monkeypatch.setattr(WssService, "serve", recording_serve)

    def target():
        try:
            serve.main(_main_argv(root, "--device", "cpu", "--port", str(port),
                                  "--max-batch", "2", "--max-delay-ms", "5"))
        except asyncio.CancelledError:
            pass
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    async def client():
        deadline = time.monotonic() + 60
        while True:
            try:
                ws = await websockets.connect(f"ws://127.0.0.1:{port}")
                break
            except OSError:
                if time.monotonic() > deadline or errors:
                    raise
                await asyncio.sleep(0.2)
        async with ws:
            await ws.send("authentication¬a-token")
            key = json.loads((await ws.recv()).split("¬")[2])
            eeg = np.random.default_rng(9).normal(size=(n_ch, T)).astype(np.float32)
            await ws.send(b"eeg|" + key.encode() + b"|" + eeg[:, :100].tobytes())
            await ws.send(b"eeg|" + key.encode() + b"|" + np.ascontiguousarray(
                eeg[:, 100:]).tobytes())
            reply = await asyncio.wait_for(ws.recv(), 60)
            await ws.send(b"eeg|nobody|" + eeg.tobytes())
            refused = await asyncio.wait_for(ws.recv(), 60)
            return reply, refused

    try:
        reply, refused = asyncio.run(client())
    finally:
        if "loop" in running:
            running["loop"].call_soon_threadsafe(running["task"].cancel)
        thread.join(30)
    assert not errors and not thread.is_alive()
    command, _, text = reply.split("¬")
    assert command == "utterance" and isinstance(text, str)
    assert refused.startswith("error¬stream¬")
