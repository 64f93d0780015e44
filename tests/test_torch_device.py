"""The port's acquisition-board twin (``device/``) against the JAX package's.

The port builds ``libistdevice.so`` itself (the host C++ compiler into
``build/native/``, ``device/native.py``); the JAX package's ``NativeBoard`` is
handed that library through ``lib_path``, so both bindings drive the same
firmware twin.  Each scenario is one function of a device namespace (``JAX``
or ``PORT``: ``NativeBoard``, ``EdgeDevice``, ``rms_scorer``,
``wake_model_scorer`` and the runtime classes of either package) that drives
the classes as ``tests/test_device_native.py`` and ``tests/test_device_edge.py``
do and returns what it observed (wire frames byte for byte, drained samples as
bytes); each test case runs one scenario through both packages and requires
equal results, and the scenarios keep the original tests' assertions.

The edge uplink with a real decode: a board behind an ``EdgeDevice`` with an
RMS scorer is fed silence, an utterance of more than two windows, then
silence; its frames go through the port's ``WssService`` (``cli.serve
.build_service``) around the port's ``build_decode_fn`` on weights converted
from the JAX model, and through the JAX service around the JAX composition
(the Pallas IIR in interpret mode, CAR, region gather, ``build_generate_fn``),
in float32 with BatchNorm unfolded (ROADMAP 3, rounding): the frames, the
utterances and the token ids must be identical.

Sizes: ``tests.helpers.tiny_config`` at T = 124 over a 48-row montage (the
board's channels, no filler rows).
"""

import ast
import asyncio
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import imagined_speech_translation_tpu.device as jax_device
import imagined_speech_translation_tpu.device.edge as jax_edge
import imagined_speech_translation_tpu.device.native as jax_native
import imagined_speech_translation_tpu.runtime as jax_runtime
import imagined_speech_translation_tpu.runtime.server as jax_server
import imagined_speech_translation_tpu_torch.device as port_device
import imagined_speech_translation_tpu_torch.device.edge as port_edge
import imagined_speech_translation_tpu_torch.device.native as port_native
import imagined_speech_translation_tpu_torch.runtime as port_runtime
import imagined_speech_translation_tpu_torch.runtime.server as port_server
from imagined_speech_translation_tpu.data import ChineseCharTokenizer as JaxTokenizer
from imagined_speech_translation_tpu.decode import DecodeParams as JaxDecodeParams
from imagined_speech_translation_tpu.decode import build_generate_fn as jax_build_generate_fn
from imagined_speech_translation_tpu.frontend import SignalFrontend as JaxFrontend
from imagined_speech_translation_tpu.frontend import common_average_reference as jax_car
from imagined_speech_translation_tpu.frontend.filters import sosfilt_pallas
from imagined_speech_translation_tpu.models import EEGDecodingModel as JaxModel
from imagined_speech_translation_tpu_torch import config
from imagined_speech_translation_tpu_torch.cli import serve
from imagined_speech_translation_tpu_torch.convert import load_flax_variables
from imagined_speech_translation_tpu_torch.data import ChineseCharTokenizer, RegionSpec
from imagined_speech_translation_tpu_torch.data.synthetic import make_synthetic_montage
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel
from tests.helpers import TINY_VOCAB, tiny_config
from tests.test_torch_models import few_threads  # noqa: F401
from tests.test_torch_models import seeded_flax_variables
from tests.test_torch_runtime import _code, _stripped
from tests.test_torch_serve import recording

LIB = port_native.build_native_library()


def _namespace(pkg_device, edge, runtime, server, board_kw):
    def make_board(**kw):
        return pkg_device.NativeBoard(**kw, **board_kw)

    return SimpleNamespace(make_board=make_board, EdgeDevice=edge.EdgeDevice,
                           rms_scorer=edge.rms_scorer, wake_model_scorer=edge.wake_model_scorer,
                           runtime=runtime, WssService=server.WssService)


JAX = _namespace(jax_device, jax_edge, jax_runtime, jax_server, {"lib_path": LIB})
PORT = _namespace(port_device, port_edge, port_runtime, port_server, {})


# ---------------------------------------------------------------------------
# tests/test_device_native.py's scenarios
# ---------------------------------------------------------------------------


def sc_bring_up_and_rates(dv):
    out = []
    for rate in (250, 500, 1000, 2000):
        with dv.make_board(data_rate_sps=rate) as b:
            b.bring_up()
            assert b.n_channels == 48
            out.append((b.n_channels, b.data_rate_sps))
    assert out[1] == (48, 500) and out[2] == (48, 1000)
    return out


def sc_quantization_roundtrip_sub_lsb(dv):
    out = []
    for gain in (1, 24):
        with dv.make_board(gain=gain) as b:
            b.bring_up()
            rng = np.random.default_rng(gain)
            analog = rng.normal(0.0, 50.0, size=(48, 32)).astype(np.float32)
            b.feed(analog)
            assert b.pump(32) == 32
            assert b.queued == 32
            digital = b.drain(32)
            lsb = 2 * (4.5e6 / gain) / 2**24
            assert digital.shape == (48, 32)
            np.testing.assert_allclose(digital, analog, atol=lsb)
            assert b.queued == 0
            out.append(digital.tobytes())
    return out


def sc_no_samples_without_bring_up(dv):
    with dv.make_board() as b:
        assert b.pump(8) == 0
        assert b.queued == 0
        return [b.queued, b.drain(4).shape]


def sc_wire_end_and_status_frames(dv):
    with dv.make_board(noise_seed=3, noise_uv=1.0) as b:
        b.bring_up()
        b.pump(40)
        frames = [b.wire_frame("KEY", 16), b.wire_frame("K", 24), b.wire_frame("K", 8)]
        assert frames[0].startswith(b"eeg|KEY|")
        arr = np.frombuffer(frames[0][len(b"eeg|KEY|"):], np.float32).reshape(48, 16)
        assert np.abs(arr).max() > 0
        assert b.end_frame("KEY") == b"eeg_end|KEY|"
        status = [b.status_frame(kind, "K", arg)
                  for kind, arg in (("ip", "10.0.0.2"), ("volume", "7"), ("battery", "93"))]
        assert status == ["ip|K|10.0.0.2", "volume|K|7", "battery|K|93"]
        with pytest.raises(ValueError):
            b.status_frame("nope", "K", "x")
        return [frames, b.end_frame("KEY"), status, b.queued]


def sc_short_drain_preserves_channel_alignment(dv):
    with dv.make_board(gain=1) as b:
        b.bring_up()
        analog = np.tile(np.arange(48, dtype=np.float32)[:, None] * 100.0, (1, 10))
        b.feed(analog)
        assert b.pump(10) == 10
        out = b.drain(20)
        assert out.shape == (48, 10)
        np.testing.assert_allclose(out, analog, atol=2 * 4.5e6 / 2**24)
        return out.tobytes()


def sc_firmware_frames_drive_the_real_server(dv):
    rt, seen = dv.runtime, []

    def decode_fn(batch):
        seen.append(batch.shape)
        return [f"w{i}" for i in range(batch.shape[0])]

    svc = dv.WssService(rt.SessionRegistry(), n_channels=48, pipeline_factory=lambda key:
                        rt.DecodePipeline(windower=rt.Windower(rt.RingBuffer(48, 4 * 64),
                                                               window=64, hop=64),
                                          decode_fn=decode_fn, max_batch=1))

    async def flow():
        reply = await svc.handle_text("authentication¬device-token")
        key = reply.split("¬")[2].strip('"')
        frames, texts = [], []
        with dv.make_board(noise_seed=11, noise_uv=5.0) as b:
            b.bring_up()
            for _ in range(3):
                b.pump(48)
                frames.append(b.wire_frame(key, 48))
                texts += await svc.handle_binary(frames[-1])
            assert len(texts) == 2
            texts += await svc.handle_binary(b.end_frame(key))
        assert len(texts) == 2
        return [f[len(key) + 5:] for f in frames], texts

    payloads, texts = asyncio.run(flow())
    assert all(s[1] == 48 and s[2] == 64 for s in seen)
    return payloads, texts, seen


# ---------------------------------------------------------------------------
# tests/test_device_edge.py's scenarios
# ---------------------------------------------------------------------------


def _edge(dv, window=128, hop=32, threshold=5.0, key="K", **board):
    b = dv.make_board(**board)
    b.bring_up()
    return dv.EdgeDevice(b, dv.rms_scorer(threshold), auth_key=key, window=window, hop=hop)


def sc_silence_produces_no_traffic(dv):
    edge = _edge(dv)
    frames = edge.poll(512)
    assert frames == [] and not edge.awake
    noisy = _edge(dv, threshold=20.0, noise_seed=2, noise_uv=5.0)
    assert noisy.poll(700) == [] and not noisy.awake
    return [frames, edge.awake, noisy.awake]


def sc_wake_cycle_emits_window_then_hops_then_end(dv):
    edge = _edge(dv, window=128, hop=32)
    edge.board.feed(np.full((48, 256), 50.0, np.float32))
    frames = edge.poll(256)
    assert edge.awake
    assert all(f.startswith(b"eeg|K|") for f in frames)
    assert np.frombuffer(frames[0][6:], np.float32).size == 48 * 128
    assert all(np.frombuffer(f[6:], np.float32).size == 48 * 32 for f in frames[1:])
    falling = edge.poll(512)
    assert falling.count(b"eeg_end|K|") == 1 and not edge.awake
    after = edge.poll(256)
    assert after == []
    return [frames, falling, after]


def sc_wake_cycle_on_a_noisy_board(dv):
    """Noise, a seeded utterance, noise, at several window and hop sizes."""
    out = []
    for window, hop in ((128, 32), (64, 64), (100, 7)):
        edge = _edge(dv, window=window, hop=hop, threshold=25.0, noise_seed=window,
                     noise_uv=5.0)
        frames = edge.poll(300)
        edge.board.feed((np.random.default_rng(hop).normal(size=(48, 400)) * 40.0)
                        .astype(np.float32))
        for _ in range(8):
            frames += edge.poll(111)
        assert np.frombuffer(frames[0][6:], np.float32).size == 48 * window
        assert frames.count(b"eeg_end|K|") == 1 and not edge.awake
        out.append(frames)
    return out


def sc_edge_uplink_through_real_server(dv):
    rt, decoded = dv.runtime, []

    def decode_fn(batch):
        decoded.append(batch.shape)
        return ["你好"] * batch.shape[0]

    svc = dv.WssService(rt.SessionRegistry(), n_channels=48, pipeline_factory=lambda key:
                        rt.DecodePipeline(windower=rt.Windower(rt.RingBuffer(48, 1024),
                                                               window=128, hop=128),
                                          decode_fn=decode_fn, max_batch=1))

    async def flow():
        reply = await svc.handle_text("authentication¬edge-tok")
        key = reply.split("¬")[2].strip('"')
        edge = _edge(dv, window=128, hop=32, key=key)
        edge.board.feed(np.full((48, 384), 50.0, np.float32))
        texts = []
        for _ in range(4):
            for frame in edge.poll(192):
                texts += await svc.handle_binary(frame)
        return texts

    texts = asyncio.run(flow())
    assert texts and all(t == "你好" for t in texts)
    assert decoded and all(s[1] == 48 for s in decoded)
    return texts, decoded


def sc_rms_and_model_scorers(dv):
    s = dv.rms_scorer(10.0)
    rms = [s(np.full((48, 64), v, np.float32)) for v in (20.0, 10.0, 9.99, 0.0, -20.0)]
    assert rms[0] and not rms[3]

    class FakeModel:
        def forward(self, x):
            return (1 if x.mean() > 0 else 0), np.array([0.5, 0.5])

    ws = dv.wake_model_scorer(FakeModel(), features=lambda w: w.mean(axis=0))
    ws2 = dv.wake_model_scorer(FakeModel(), features=lambda w: w.mean(axis=0), wake_class=0)
    model = [f(np.full((48, 64), v, np.float32)) for f in (ws, ws2) for v in (1.0, -1.0)]
    assert model == [True, False, False, True]
    return rms, model


def sc_edge_rejects_a_hop_beyond_the_window(dv):
    b = dv.make_board()
    try:
        dv.EdgeDevice(b, dv.rms_scorer(1.0), auth_key="K", window=8, hop=9)
    except ValueError as e:
        return str(e)
    finally:
        b.close()
    return None


SCENARIOS = [sc_bring_up_and_rates, sc_quantization_roundtrip_sub_lsb,
             sc_no_samples_without_bring_up, sc_wire_end_and_status_frames,
             sc_short_drain_preserves_channel_alignment, sc_firmware_frames_drive_the_real_server,
             sc_silence_produces_no_traffic, sc_wake_cycle_emits_window_then_hops_then_end,
             sc_wake_cycle_on_a_noisy_board, sc_edge_uplink_through_real_server,
             sc_rms_and_model_scorers, sc_edge_rejects_a_hop_beyond_the_window]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_device_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


# ---------------------------------------------------------------------------
# the native library: the port's own build
# ---------------------------------------------------------------------------


def test_library_builds_into_build_native():
    repo = port_native._REPO_ROOT
    assert LIB == repo / "build" / "native" / "libistdevice.so" and LIB.exists()
    assert port_native.find_native_library() == LIB
    assert port_native.build_native_library() == LIB  # fresh: no rebuild
    code = ast.unparse(_stripped(port_native))  # docstrings aside
    assert '"build"' not in code.replace('_REPO_ROOT / "build" / "native"', "")


def test_failed_build_raises_with_the_compilers_stderr(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and raises its stderr."""
    fake = tmp_path / "fakecxx"
    fake.write_text("#!/bin/sh\necho 'fatal: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    build = tmp_path / "native"
    monkeypatch.setattr(port_native, "_BUILD_DIR", build)
    monkeypatch.setattr(port_native, "_LIBRARY", build / "libistdevice.so")
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(RuntimeError, match="no compiler here"):
        port_native.build_native_library()
    assert sorted(p.name for p in build.iterdir()) == ["libistdevice.lock"]


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than a source is not found, and the build replaces it."""
    build = tmp_path / "native"
    build.mkdir()
    lib = build / "libistdevice.so"
    lib.write_bytes(b"stale")
    monkeypatch.setattr(port_native, "_BUILD_DIR", build)
    monkeypatch.setattr(port_native, "_LIBRARY", lib)
    import os

    os.utime(lib, (0, 0))
    assert port_native.find_native_library() is None
    assert port_native.build_native_library() == lib
    assert lib.stat().st_size > 1000 and port_native.find_native_library() == lib
    with port_device.NativeBoard(lib_path=lib) as b:
        b.bring_up()
        assert b.pump(4) == 4


# ---------------------------------------------------------------------------
# the edge uplink into the port's service with the real decode
# ---------------------------------------------------------------------------

T = 124
VOCAB = list(dict.fromkeys(TINY_VOCAB))
EDGE_WINDOW, EDGE_HOP, THRESHOLD_UV, CHUNK = 32, 8, 25.0, 31


def edge_frames(dv, seed, key):
    """One board (noise 5 uV from ``seed``) behind an edge device: silence,
    an utterance of 2 windows and a half at 40 uV, silence; polled in chunks
    of ``CHUNK`` samples.  Returns the frames and the number of polls before
    the first frame and after the ``eeg_end``."""
    board = dv.make_board(noise_seed=seed, noise_uv=5.0)
    board.bring_up()
    edge = dv.EdgeDevice(board, dv.rms_scorer(THRESHOLD_UV), auth_key=key,
                         window=EDGE_WINDOW, hop=EDGE_HOP)
    frames = []
    for _ in range(4):
        frames += edge.poll(CHUNK)
    silent_before = len(frames) == 0
    utter = np.random.default_rng(100 + seed).normal(size=(48, 5 * T // 2)) * 40.0
    board.feed(utter.astype(np.float32))
    for _ in range(utter.shape[1] // CHUNK + 4):
        frames += edge.poll(CHUNK)
    end = frames.index(("eeg_end|" + key + "|").encode())
    tail = []
    for _ in range(6):
        tail += edge.poll(CHUNK)
    board.close()
    return frames, silent_before, frames[end + 1:] + tail


def payload_windows(frames, key):
    """The ``(48, n)`` samples of the ``eeg`` frames, concatenated, and the
    whole windows of ``T`` they hold."""
    head = ("eeg|" + key + "|").encode()
    x = np.concatenate([np.frombuffer(f[len(head):], np.float32).reshape(48, -1)
                        for f in frames if f.startswith(head)], axis=1)
    return [x[:, k * T:(k + 1) * T] for k in range(x.shape[1] // T)]


@pytest.fixture(scope="module")
def uplink_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("uplink")
    jcfg = tiny_config(len(VOCAB), n_timepoints=T)
    cfg = config.Config.from_json(jcfg.to_json())
    labels = make_synthetic_montage(root / "montage.csv", 48)
    spec = RegionSpec.from_channel_names(labels)
    variables = seeded_flax_variables(
        JaxModel(jcfg.model), np.zeros((1, 4, 16, T), np.float32), np.zeros((1, 4), np.int32),
        spec.channel_mask, seed=4)
    model = load_flax_variables(EEGDecodingModel(cfg.model, T).eval(), variables)
    return dict(jcfg=jcfg, cfg=cfg, spec=spec, variables=variables, model=model)


def jax_unfolded_decode_fn(s, tok):
    """The JAX serving computation on the same weights, BatchNorm unfolded."""
    jcfg, spec = s["jcfg"], s["spec"]
    g = jcfg.generation
    generate = jax_build_generate_fn(JaxModel(jcfg.model), JaxDecodeParams(
        max_length=g.max_length, min_length=g.min_length, num_beams=g.num_beams,
        pad_token_id=tok.pad_token_id, eos_token_id=tok.sep_token_id,
        decoder_start_token_id=tok.bos_token_id), jit=False)
    fe = JaxFrontend(jcfg.frontend)
    gather, mask = jnp.asarray(spec.gather_indices.reshape(-1)), jnp.asarray(spec.channel_mask)
    R, C = spec.channel_mask.shape
    variables = jax.tree.map(jnp.asarray, s["variables"])

    @jax.jit
    def run(raw):
        clean = jax_car(sosfilt_pallas([fe.sos_bandpass, fe.sos_notch], raw, interpret=True))
        stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
        stacked = jnp.where(mask[None, :, :, None], stacked, 0.0)
        return generate(variables, stacked, mask)

    def decode_fn(windows):
        tokens = np.asarray(run(jnp.asarray(windows, jnp.float32)))
        return [t.strip() for t in tok.batch_decode(tokens)]

    return decode_fn


def uplink(dv, decode_fn, sessions=3):
    """``sessions`` boards, each behind an edge device, signed in to a
    ``WssService`` (one ``DecodePipeline`` a session, hop = window = T,
    as ``cli.serve.main`` wires it without pooling) and streaming their
    frames concurrently.  Returns each session's frames (payloads only) and
    utterances, and the silence checks."""
    rt = dv.runtime
    svc = dv.WssService(rt.SessionRegistry(), n_channels=48, pipeline_factory=lambda key:
                        rt.DecodePipeline(windower=rt.Windower(rt.RingBuffer(48, 4 * T),
                                                               window=T, hop=T),
                                          decode_fn=decode_fn, max_batch=1))

    async def session(i):
        key = json.loads((await svc.handle_text(f"authentication¬board{i}")).split("¬")[2])
        frames, before, after = edge_frames(dv, i, key)
        texts = []
        for f in frames:
            texts += await svc.handle_binary(f)
            await asyncio.sleep(0)
        head = len(key) + 2  # the key between two bars
        wire = [(f[:f.index(b"|")], f[f.index(b"|") + head:]) for f in frames]
        return payload_windows(frames, key), wire, texts, before, after

    async def run():
        return await asyncio.gather(*(session(i) for i in range(sessions)))

    return asyncio.run(run())


def test_edge_uplink_decodes_the_jax_ids(uplink_setup):
    s = uplink_setup
    jtok = recording(JaxTokenizer)(VOCAB, eos_token="[EOS]")
    want = uplink(JAX, jax_unfolded_decode_fn(s, jtok))

    tok = recording(ChineseCharTokenizer)(VOCAB, eos_token="[EOS]")
    decode_fn = serve.build_decode_fn(s["cfg"], tok, s["spec"], s["model"], device="cpu",
                                      fold_bn=False)
    got = uplink(PORT, decode_fn)

    for (windows, payloads, texts, before, after), theirs in zip(got, want):
        assert before and after == []  # silent before the rise and after the fall
        assert len(windows) >= 2 and len(texts) == len(windows)
        assert payloads == theirs[1] and texts == theirs[2]
    ids, jids = np.concatenate(tok.history), np.concatenate(jtok.history)
    np.testing.assert_array_equal(ids, jids)
    assert ids.shape[0] == sum(len(g[0]) for g in got)
    # the service decoded the windows the frames hold, in order: the direct
    # decode of each window gives the same ids
    for i, w in enumerate(w for g in got for w in g[0]):
        decode_fn(w[None])
        np.testing.assert_array_equal(tok.history[-1], ids[i:i + 1])


# ---------------------------------------------------------------------------
# the copies' code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("port, jax_mod", [(port_device, jax_device), (port_edge, jax_edge)],
                         ids=["device", "device.edge"])
def test_copied_module_code_is_the_original(port, jax_mod):
    assert _code(port) == _code(jax_mod)


def _nodes(module, names):
    """The module's top-level statements that bind ``names``, docstrings
    stripped."""
    out = {}
    for node in _stripped(module).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name in names:
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) in names:
            out[node.targets[0].id] = ast.dump(node)
    return out


def test_native_binding_is_the_original_but_for_its_build():
    """``device/native.py`` equals the original apart from where the library
    is found and how it is built."""
    same = ("N_CHANNELS", "_load", "NativeBoard", "_REPO_ROOT", "_NATIVE_DIR")
    assert _nodes(port_native, same) == _nodes(jax_native, same)
    assert len(_nodes(port_native, same)) == len(same)
    assert port_device.__all__ == jax_device.__all__
