"""The port's serving runtime (``imagined_speech_translation_tpu_torch.runtime``)
against the JAX package's jax-free originals it copies.

Each scenario is one function of a runtime namespace (``JAX`` or ``PORT``,
the same module names in either package) that drives the classes as
``tests/test_runtime.py``, ``tests/test_batcher.py:194-327`` and
``tests/test_runtime_services.py`` do, with a fake decode function, and
returns what it observed as plain data (random access keys and wall-clock
times left out).  Each test case runs one scenario through both packages
and requires equal results; the scenarios keep the original tests'
assertions too.  ``tests/test_product_journey.py``'s journey runs through
the port's ``WssService`` with the JAX package's companion client, and with
the port's companion (client, BLE link, device page) against the JAX
companion on the JAX service.  Besides, each copied module's code (its docstrings and comments aside) must be the
original's, and the package exports the same names.
"""

import ast
import asyncio
import base64
import dataclasses
import functools
import importlib
import inspect
import json
import random
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

MODULES = ("protocol", "streaming", "batcher", "session", "dsl", "auth", "personalization",
           "services", "actions", "commands", "server", "worker", "adapters", "media",
           "reminders")


def _runtime(pkg):
    ns = SimpleNamespace(**{m: importlib.import_module(f"{pkg}.runtime.{m}") for m in MODULES})
    ns.pkg = importlib.import_module(f"{pkg}.runtime")
    return ns


JAX = _runtime("imagined_speech_translation_tpu")
PORT = _runtime("imagined_speech_translation_tpu_torch")


def run(coro):
    return asyncio.run(coro)


def outcome(fn, *args):
    """``("ok", value)`` or ``("raises", exception class name, message)``."""
    try:
        value = fn(*args)
        if inspect.isawaitable(value):
            value = run(value)
        return ("ok", value)
    except Exception as e:  # noqa: BLE001 - the outcome is the result
        return ("raises", type(e).__name__, str(e))


async def aoutcome(coro):
    try:
        return ("ok", await coro)
    except Exception as e:  # noqa: BLE001
        return ("raises", type(e).__name__, str(e))


def _key(reply: str) -> str:
    """The access key of an ``ok¬authentication¬"<key>"`` reply."""
    return reply.split("¬")[2].strip('"')


# ---------------------------------------------------------------------------
# the scenarios of tests/test_runtime.py
# ---------------------------------------------------------------------------


def sc_text_frame_roundtrip(rt):
    p = rt.protocol
    f = p.TextFrame("send_data", "key123", ("hello", "世界"))
    enc = p.encode_text_frame(f)
    assert p.decode_text_frame(enc) == f
    f2 = p.decode_text_frame("authentication¬token")
    assert f2.command == "authentication" and f2.access_key == "token"
    return [enc, dataclasses.astuple(p.decode_text_frame(enc)), dataclasses.astuple(f2),
            p.encode_text_frame(p.TextFrame("ping")),
            outcome(p.decode_text_frame, ""), outcome(p.decode_text_frame, "¬k¬a")]


def sc_binary_frame_roundtrip(rt):
    p = rt.protocol
    payload = bytes(range(256))  # includes b'|' bytes in the payload
    f = p.BinaryFrame("eeg", "key", payload)
    enc = p.encode_binary_frame(f)
    assert p.decode_binary_frame(enc) == f
    return [enc, dataclasses.astuple(p.decode_binary_frame(enc)),
            outcome(p.decode_binary_frame, b"nodelimiters"),
            outcome(p.decode_binary_frame, b"eeg|nokey"),
            outcome(p.encode_binary_frame, p.BinaryFrame("a|b", "k", b""))]


def _dsl_registry(log):
    def speak(text):
        log.append(("speak", text))
        return f"spoke:{text}"

    async def get_name():
        return "Alex"

    def send_email(to, body):
        log.append(("email", to, body))
        return "sent"

    return {"speak": speak, "get_name": get_name, "send_email": send_email}


def sc_dsl_parse_structure(rt):
    calls = rt.dsl.Parser().parse("speak(|hello|)¬send_email(|a@b.c|,|hi|)¬f(g(|x|)^|y|)")
    assert [c.name for c in calls] == ["speak", "send_email", "f"]
    return [repr(c) for c in calls]


def sc_dsl_execute_with_nesting_and_concat(rt):
    log = []
    results = run(rt.dsl.Parser(_dsl_registry(log)).execute("speak(|hello |^get_name())"))
    assert results == ["spoke:hello Alex"]
    return results, log


def sc_dsl_nested_call_as_argument(rt):
    log = []
    results = run(rt.dsl.Parser(_dsl_registry(log)).execute("send_email(|x@y.z|,speak(|msg|))"))
    assert log == [("speak", "msg"), ("email", "x@y.z", "spoke:msg")]
    return results, log


def sc_dsl_errors(rt):
    p = rt.dsl.Parser({})
    out = [outcome(p.parse, "speak(|unterminated"), outcome(p.parse, "(|no name|)"),
           outcome(p.parse, "speak(|a|) trailing"), outcome(p.execute, "unknown_fn()")]
    assert all(o[:2] == ("raises", "DslError") for o in out)
    return out


def sc_dsl_separator_inside_string(rt):
    log = []
    run(rt.dsl.Parser(_dsl_registry(log)).execute("speak(|contains ¬ inside|)"))
    assert log == [("speak", "contains ¬ inside")]
    return log


def sc_session_auth_gate_and_dispatch(rt):
    reg = rt.session.SessionRegistry()

    @reg.command("echo")
    async def echo(session, args):
        return [session.user_id, *args]

    async def flow():
        out = [await aoutcome(reg.dispatch(rt.protocol.TextFrame("echo", "badkey", ("x",))))]
        key = await reg.dispatch(rt.protocol.TextFrame("authentication", "user-token"))
        assert isinstance(key, str) and reg.get(key).authenticated
        out.append(len(reg))
        out.append(await reg.dispatch(rt.protocol.TextFrame("echo", key, ("a", "b"))))
        out.append(await aoutcome(reg.dispatch(rt.protocol.TextFrame("nope", key))))
        await reg.drop(key)
        out.append((reg.get(key), len(reg)))
        return out

    return run(flow())


def sc_session_rejects_empty_token(rt):
    reg = rt.session.SessionRegistry()
    return [outcome(reg.dispatch, rt.protocol.TextFrame("authentication", "")),
            outcome(reg.dispatch, rt.protocol.TextFrame("authentication", "", ("tok",)))[0]]


def sc_ring_buffer_wraparound(rt):
    rb = rt.streaming.RingBuffer(2, 10)
    out = []
    rb.push(np.arange(8, dtype=np.float32).reshape(2, 4))
    out += [rb.filled, rb.latest(2).tolist()]
    rb.push(np.arange(100, 116, dtype=np.float32).reshape(2, 8))
    out += [rb.filled, rb.total_written, rb.latest(10).tolist()]
    rb.push(np.arange(40, dtype=np.float32).reshape(2, 20))  # keeps the newest 10
    out += [rb.latest(10).tolist(), outcome(rb.latest, 11),
            outcome(rb.push, np.zeros((3, 1), np.float32))]
    assert out[-3][0] == list(range(10, 20))
    return out


def sc_windower_emits_on_hop(rt):
    rb = rt.streaming.RingBuffer(1, 64)
    w = rt.streaming.Windower(rb, window=16, hop=8)
    polls = []
    for n in (15, 3, 8, 40):
        rb.push(np.arange(rb.total_written, rb.total_written + n, dtype=np.float32)[None])
        polls.append([x.tolist() for x in w.poll()])
    assert polls[0] == [] and len(polls[1]) == 1 and len(polls[2]) == 1
    return polls


def sc_decode_pipeline_gating_and_latency(rt):
    windower = rt.streaming.Windower(rt.streaming.RingBuffer(2, 128), window=32, hop=32)
    calls = []

    def decode_fn(batch):
        calls.append(batch.shape)
        return [f"text{i}" for i in range(batch.shape[0])]

    pipe = rt.streaming.DecodePipeline(windower=windower, decode_fn=decode_fn,
                                       wake_gate=rt.streaming.ThresholdWakeGate(0.5),
                                       max_batch=2)
    quiet = pipe.feed(np.zeros((2, 64), np.float32))
    out = [quiet, pipe.flush()]
    out.append(pipe.feed(np.ones((2, 64), np.float32) * 2.0))
    out.append(pipe.feed(np.ones((2, 32), np.float32) * 2.0))  # one window pends
    out.append(pipe.flush())
    stats = pipe.latency.summary()
    assert out[2] == ["text0", "text1"] and stats["p50_ms"] is not None
    return out, calls, stats["count"], sorted(stats)


def sc_wss_service_text_and_binary(rt):
    reg = rt.session.SessionRegistry()

    @reg.command("speak")
    async def speak(session, args):
        return {"spoken": args[0]}

    def pipeline_factory(key):
        return rt.streaming.DecodePipeline(
            windower=rt.streaming.Windower(rt.streaming.RingBuffer(4, 256), window=64, hop=64),
            decode_fn=lambda b: ["你好"] * b.shape[0], max_batch=1)

    svc = rt.server.WssService(reg, pipeline_factory=pipeline_factory, n_channels=4)
    p = rt.protocol

    async def flow():
        key = _key(await svc.handle_text("authentication¬tok"))
        out = [await svc.handle_text(f"speak¬{key}¬你好")]
        samples = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
        out.append(await svc.handle_binary(
            p.encode_binary_frame(p.BinaryFrame("eeg", key, samples.tobytes()))))
        out.append(await svc.handle_binary(
            p.encode_binary_frame(p.BinaryFrame("eeg_end", key, b""))))
        out.append(await aoutcome(svc.handle_binary(
            p.encode_binary_frame(p.BinaryFrame("eeg", "nope", samples.tobytes())))))
        out.append(await aoutcome(svc.handle_binary(
            p.encode_binary_frame(p.BinaryFrame("video", key, b"")))))
        out.append(await aoutcome(svc.handle_binary(
            p.encode_binary_frame(p.BinaryFrame("audio", key, b"\x00")))))
        out.append(await svc.handle_text("¬¬"))
        out.append(await svc.handle_text(f"speak¬{key}x¬hi"))
        out.append(await svc.handle_text(f"nosuch¬{key}"))
        return out

    out = run(flow())
    assert out[0].startswith("ok¬speak") and out[1] == ["你好"]
    return out


RUNTIME_SCENARIOS = [
    sc_text_frame_roundtrip, sc_binary_frame_roundtrip, sc_dsl_parse_structure,
    sc_dsl_execute_with_nesting_and_concat, sc_dsl_nested_call_as_argument, sc_dsl_errors,
    sc_dsl_separator_inside_string, sc_session_auth_gate_and_dispatch,
    sc_session_rejects_empty_token, sc_ring_buffer_wraparound, sc_windower_emits_on_hop,
    sc_decode_pipeline_gating_and_latency, sc_wss_service_text_and_binary,
]


# ---------------------------------------------------------------------------
# the pipeline scenarios of tests/test_batcher.py:194-327
# ---------------------------------------------------------------------------


class RecordingDecoder:
    """decode_fn recording each batch; a row's text encodes its mean."""

    def __init__(self):
        self.batches: list[np.ndarray] = []

    def __call__(self, batch: np.ndarray) -> list[str]:
        self.batches.append(np.array(batch))
        return [f"t{batch[i].mean():.3f}" for i in range(batch.shape[0])]


def _shapes(dec):
    return [b.shape for b in dec.batches]


def sc_batching_pipeline_windowing_and_gate(rt):
    dec = RecordingDecoder()

    async def flow():
        async with rt.batcher.BatchScheduler(dec, max_batch=4, max_delay_ms=10) as s:
            pipe = rt.batcher.BatchingDecodePipeline(
                windower=rt.streaming.Windower(rt.streaming.RingBuffer(2, 64), window=8, hop=8),
                scheduler=s, wake_gate=lambda w: float(w.mean()) > 0.5)
            out = [await pipe.feed(np.zeros((2, 8), np.float32)),
                   await pipe.feed(np.ones((2, 8), np.float32)),
                   await pipe.feed(np.full((2, 16), 2.0, np.float32)),
                   await pipe.flush()]
            stats = s.stats()
            return out, stats["count"], stats["batches"], stats["mean_fill"]

    out = run(flow())
    assert out[0] == [[], ["t1.000"], ["t2.000", "t2.000"], []]
    return out, _shapes(dec)


def sc_wss_service_with_batching_pipeline(rt):
    dec = RecordingDecoder()
    p = rt.protocol

    async def flow():
        async with rt.batcher.BatchScheduler(dec, max_batch=2, max_delay_ms=5_000) as s:
            svc = rt.server.WssService(
                rt.session.SessionRegistry(),
                pipeline_factory=lambda key: rt.batcher.BatchingDecodePipeline(
                    windower=rt.streaming.Windower(rt.streaming.RingBuffer(4, 256), window=16,
                                                   hop=16),
                    scheduler=s),
                n_channels=4)
            keys = [_key(await svc.handle_text(f"authentication¬{t}")) for t in ("tokA", "tokB")]
            frames = [p.encode_binary_frame(p.BinaryFrame(
                "eeg", key, np.full((4, 16), float(i + 1), np.float32).tobytes()))
                for i, key in enumerate(keys)]
            ta, tb = await asyncio.gather(svc.handle_binary(frames[0]),
                                          svc.handle_binary(frames[1]))
            ends = [await svc.handle_binary(p.encode_binary_frame(p.BinaryFrame("eeg_end", k)))
                    for k in keys]
            return [ta, tb, ends, list(s.fills)]

    out = run(flow())
    assert out[:2] == [["t1.000"], ["t2.000"]] and out[3] == [2]
    return out, _shapes(dec)


def sc_mismatched_window_shape_rejected_at_submit(rt):
    dec = RecordingDecoder()

    async def flow():
        async with rt.batcher.BatchScheduler(dec, max_batch=2, max_delay_ms=10) as s:
            good = asyncio.ensure_future(s.submit(np.full((2, 8), 1.0, np.float32)))
            await asyncio.sleep(0)  # good window enqueued, shape learned
            bad = await aoutcome(s.submit(np.zeros((3, 5), np.float32)))
            return [bad, await good]

    out = run(flow())
    assert out[1] == "t1.000"
    return out, _shapes(dec)


def sc_short_decode_output_errors_instead_of_hanging(rt):
    async def flow():
        async with rt.batcher.BatchScheduler(lambda b: ["only-one"], max_batch=2,
                                             max_delay_ms=10) as s:
            res = await asyncio.gather(s.submit(np.ones((2, 8), np.float32)),
                                       s.submit(np.ones((2, 8), np.float32)),
                                       return_exceptions=True)
            return [(type(r).__name__, str(r)) for r in res]

    out = run(flow())
    assert all(name == "RuntimeError" for name, _ in out)
    return out


def sc_feed_delivers_partial_successes(rt):
    class FlakyDecoder(RecordingDecoder):
        def __call__(self, batch):
            if not self.batches:  # fail only the FIRST launch
                self.batches.append(np.zeros(0))
                raise ValueError("transient")
            return super().__call__(batch)

    async def flow(dec, gate):
        async with rt.batcher.BatchScheduler(dec, max_batch=1, max_delay_ms=5) as s:
            pipe = rt.batcher.BatchingDecodePipeline(
                windower=rt.streaming.Windower(rt.streaming.RingBuffer(2, 64), window=8, hop=8),
                scheduler=s, wake_gate=gate)
            return await aoutcome(pipe.feed(np.full((2, 16), 2.0, np.float32)))

    def first_window_only():
        seen = []

        def gate(w):
            seen.append(1)
            return len(seen) == 1

        return gate

    partial = run(flow(FlakyDecoder(), None))
    # a lone gated window whose one batch fails: the failure surfaces
    lone = run(flow(FlakyDecoder(), first_window_only()))
    assert partial == ("ok", ["t2.000"]) and lone[:2] == ("raises", "RuntimeError")
    return partial, lone


BATCHER_SCENARIOS = [
    sc_batching_pipeline_windowing_and_gate, sc_wss_service_with_batching_pipeline,
    sc_mismatched_window_shape_rejected_at_submit,
    sc_short_decode_output_errors_instead_of_hanging, sc_feed_delivers_partial_successes,
]
# ---------------------------------------------------------------------------
# the scenarios of tests/test_runtime_services.py
# ---------------------------------------------------------------------------


def _bundle_registry(rt):
    bundle = rt.services.ServiceBundle()
    return bundle, rt.commands.build_command_registry(bundle)


async def _auth(rt, reg, token="user@example.com"):
    return await reg.dispatch(rt.protocol.TextFrame("authentication", token))


def _dispatch_all(rt, reg, frames):
    """Authenticate, then dispatch ``(command, args)`` frames in order."""
    async def flow():
        key = await _auth(rt, reg)
        return [await aoutcome(reg.dispatch(rt.protocol.TextFrame(c, key, a)))
                for c, a in frames]

    return run(flow())


def sc_all_reference_commands_registered(rt):
    _, reg = _bundle_registry(rt)
    assert set(rt.commands.COMMAND_NAMES) <= set(reg._handlers)
    return list(rt.commands.COMMAND_NAMES), sorted(reg._handlers)


def sc_onboarding_flow(rt):
    _, reg = _bundle_registry(rt)
    out = _dispatch_all(rt, reg, [
        ("first_time", ()), ("first_time", ()), ("not_first_time", ()), ("first_time", ()),
        ("ble_id", ("AA:BB",)), ("ble_id", ())])
    assert out[0] == ("ok", {"first_time": True}) and out[3] == ("ok", {"first_time": False})
    return out


def sc_token_and_profile_commands(rt):
    bundle, reg = _bundle_registry(rt)
    out = _dispatch_all(rt, reg, [
        ("auth_code", ("server-code",)), ("get_refresh_token", ()), ("get_auth_code", ()),
        ("get_display_name", ()), ("add_query", ("my emails...",)),
        ("send_data", ("你好",)), ("process", ("hi",))])
    assert out[1][1]["refresh_token"].startswith("rt_") and "你好" in out[5][1]["response"]
    return out, sorted(bundle.store.data.items())


def sc_media_and_maps_commands(rt):
    _, reg = _bundle_registry(rt)
    out = _dispatch_all(rt, reg, [
        ("speak", ("hello",)), ("stream_song", ("song",)), ("directions", ("Home", "Work")),
        ("get_place", ("cafe",)), ("vision", ("aGk=", "what")), ("vision", ())])
    assert out[0][1]["pcm_bytes"] > 0 and len(out[2][1]["steps"]) == 2
    return out


def sc_registry_matches_reference_names(rt):
    actions = rt.actions.UserActions(rt.services.ServiceBundle(), user_id="u1")
    registry = rt.actions.build_action_registry(actions)
    assert set(registry) == set(rt.actions.REGISTRY_NAMES) and len(registry) == 34
    return list(rt.actions.REGISTRY_NAMES), sorted(registry)


def _device_log(device):
    """The device channel's messages, byte payloads by length."""
    return [(k, len(p) if isinstance(p, bytes) else p) for k, p in device.sent]


def sc_dsl_drives_actions_end_to_end(rt):
    device = rt.actions.DeviceChannel()
    parser = rt.dsl.Parser(rt.actions.build_action_registry(
        rt.actions.UserActions(rt.services.ServiceBundle(), device, user_id="u1")))

    async def flow():
        out = [await parser.execute(
            "add_calendar_event(|Standup|,|2026-08-17T09:00|,|2026-08-17T09:15|)"
            "¬speak(|added |^get_calendar_events(|2026-08-17|))")]
        tid = (await parser.execute("add_task(|buy milk|)"))[0]
        for prog in ("get_tasks()", f"update_task(|{tid}|,|buy oat milk|)", "get_tasks()",
                     f"delete_task(|{tid}|)", "get_tasks()"):
            out.append(await parser.execute(prog))
        mid = (await parser.execute("send_email(|a@b.c|,|Hi|,|body text|)"))[0]
        for prog in ("search_emails(|body|)", f"read_email(|{mid}|)",
                     f"reply_email(|{mid}|,|thanks|)", "search_emails(|thanks|)",
                     "write_document(|notes|,|第一行|)", "get_document(|notes|)",
                     "write_sheet(|data|,|a,b\nc,d|)", "get_sheet(|data|)",
                     "change_volume(|80|)", "call(|Mom|)", "text(|Mom|,|hi|)",
                     "start_route(|Work|)", "stop_route()", "get_place(|cafe|)",
                     "take_picture()", "start_recording()", "stop_recording()",
                     "play_song(|x|)", "contacts()", "listen()", "record_speed()",
                     "stop_speed()", "process(|hello|)", "send_data(|hi|)"):
            out.append(await parser.execute(prog))
        return out

    out = run(flow())
    assert out[0][0].startswith("ev") and "Standup" in out[0][1]
    return out, _device_log(device)


def sc_calendar_update_delete(rt):
    parser = rt.dsl.Parser(rt.actions.build_action_registry(
        rt.actions.UserActions(rt.services.ServiceBundle(), user_id="u1")))

    async def flow():
        eid = (await parser.execute(
            "add_calendar_event(|Gym|,|2026-08-18T18:00|,|2026-08-18T19:00|)"))[0]
        return [eid] + [await parser.execute(p) for p in (
            f"update_calendar_event(|{eid}|,|Gym + Sauna|)", "get_calendar_events()",
            f"delete_calendar_event(|{eid}|)", "get_calendar_events()",
            f"delete_calendar_event(|{eid}|)")]

    out = run(flow())
    assert out[4] == ["no events"] and out[5] == ["not_found"]
    return out


def sc_tts_cache_per_user(rt):
    bundle = rt.services.ServiceBundle()
    assert isinstance(bundle.tts, rt.services.CachingTTS)
    tts = rt.services.CachingTTS(max_entries_per_user=2)

    async def flow():
        out = [len(await bundle.tts.synthesize(t, u))
               for t, u in (("hello", "alice"), ("hello", "alice"), ("hello", "bob"))]
        for text in ("a", "b", "c", "a"):  # FIFO eviction at 2 entries a user
            await tts.synthesize(text, "u")
        return out, bundle.tts.cache_info(), tts.cache_info(), sorted(tts._cache["u"])

    out = run(flow())
    assert out[1] == {"hits": 1, "misses": 2, "users": 2}
    return out


def sc_speak_command_hits_cache(rt):
    bundle, reg = _bundle_registry(rt)
    out = _dispatch_all(rt, reg, [("speak", ("same text",)), ("speak", ("same text",))])
    assert bundle.tts.cache_info()["hits"] == 1
    return out, bundle.tts.cache_info()


def _png(w, h):
    return (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
            + struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))


def _jpeg(w, h):
    return (b"\xff\xd8" + b"\xff\xe0" + struct.pack(">H", 4) + b"JF"
            + b"\xff\xc0" + struct.pack(">HBHH", 11, 8, h, w) + b"\x03" + b"\x00" * 8)


def sc_vision_decodes_real_image(rt):
    _, reg = _bundle_registry(rt)
    images = [_png(32, 16), _jpeg(640, 480), b"raw bytes"]
    out = _dispatch_all(rt, reg, [("vision", (base64.b64encode(i).decode(), "what"))
                                  for i in images] + [("vision", ("@@not-b64@@",))])
    assert "png 32x16" in out[0][1]["response"] and "jpeg 640x480" in out[1][1]["response"]
    return out


def sc_jwt_authenticator_accept_and_reject(rt):
    a = rt.auth
    secret = "test-secret"
    now = time.time()
    token = a.sign_token({"email": "a@b.com", "exp": int(now) + 3600}, secret, ttl_s=None)
    expired = a.sign_token({"email": "a@b.com", "exp": 1}, secret, ttl_s=None)
    fixed = a.sign_token({"sub": "s", "aud": "x", "exp": 4_000_000_000}, b"k", ttl_s=None)
    out = [token, expired, fixed] + [
        a.verify_token(*args, **kw) for args, kw in (
            ((token, secret), {}), ((token + "x", secret), {}), ((token, "other"), {}),
            ((expired, secret), {}), (("not.a.jwt", secret), {}), (("a.b", secret), {}),
            ((fixed, b"k"), {"audience": "x"}), ((fixed, b"k"), {"audience": "y"}),
            ((fixed, b"k"), {"now": 4_000_000_001}))]
    reg = rt.session.SessionRegistry(authenticator=a.make_token_authenticator(secret))

    async def flow():
        key = await reg.dispatch(rt.protocol.TextFrame("authentication", token))
        return [reg.get(key).user_id,
                await aoutcome(reg.dispatch(rt.protocol.TextFrame("authentication", "garbage")))]

    out += run(flow())
    assert out[3]["email"] == "a@b.com" and out[-2] == "a@b.com"
    return out


@functools.lru_cache(maxsize=None)
def _rsa_keypair(i):
    """A local RS256 keypair (test side only: the verifier is pure Python);
    cached, so both packages see the same keys."""
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_numbers()
    return key, pub.n, pub.e


def _b64u(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def _rs256_sign(key, claims: dict, *, kid: str, alg: str = "RS256") -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = {"alg": alg, "typ": "JWT", "kid": kid}
    signing_input = (_b64u(json.dumps(header, separators=(",", ":")).encode()) + "."
                     + _b64u(json.dumps(claims, separators=(",", ":")).encode()))
    sig = key.sign(signing_input.encode(), padding.PKCS1v15(), hashes.SHA256())
    return signing_input + "." + _b64u(sig)


def _jwk(n: int, e: int, kid: str) -> dict:
    return {"kty": "RSA", "kid": kid, "use": "sig",
            "n": _b64u(n.to_bytes((n.bit_length() + 7) // 8, "big")),
            "e": _b64u(e.to_bytes((e.bit_length() + 7) // 8, "big"))}


EXP = 4_000_000_000  # far in the future: the tokens are the same in both runs


def sc_rs256_jwks_verifier(rt):
    key, n, e = _rsa_keypair(0)
    other, n2, e2 = _rsa_keypair(1)
    jwks = {"keys": [_jwk(n, e, "kid-1"), _jwk(n2, e2, "kid-2"),
                     {"kty": "EC", "kid": "ec"}, dict(_jwk(n, e, "enc"), use="enc")]}
    claims = {"email": "a@b.com", "iss": "https://accounts.google.com", "aud": "client-123",
              "exp": EXP}
    v = rt.auth.JwksVerifier(jwks, issuer="https://accounts.google.com", audience="client-123")
    tok = _rs256_sign(key, claims, kid="kid-1")
    h, p, s = tok.split(".")
    no_exp = {k: x for k, x in claims.items() if k != "exp"}
    nbytes = n.to_bytes((n.bit_length() + 7) // 8, "big")
    cases = [
        tok, _rs256_sign(other, claims, kid="kid-1"), h + "." + p[:-2] + "xx" + "." + s,
        _rs256_sign(key, dict(claims, exp=10), kid="kid-1"),
        _rs256_sign(key, no_exp, kid="kid-1"), _rs256_sign(key, claims, kid="kid-404"),
        _rs256_sign(key, claims, kid="ec"), _rs256_sign(key, claims, kid="enc"),
        rt.auth.sign_token(claims, nbytes, ttl_s=None),
        _rs256_sign(key, dict(claims, iss="https://evil.example"), kid="kid-1"),
        _rs256_sign(key, dict(claims, aud="other-client"), kid="kid-1"),
        _rs256_sign(key, dict(claims, aud=["x", "client-123"]), kid="kid-1"),
        _rs256_sign(key, dict(claims, nbf=EXP - 1), kid="kid-1"),
        _rs256_sign(other, claims, kid="kid-2"), "a.b",
    ]
    out = [v.verify(t) for t in cases] + [v.verify(tok, now=EXP + 1)]
    assert out[0]["email"] == "a@b.com" and out[1] is None and out[11] is not None
    return out


def sc_rs256_jwks_rotation_and_authenticator(rt):
    key, n, e = _rsa_keypair(0)
    claims = {"email": "rot@b.com", "exp": EXP}
    sets = [{"keys": []}, {"keys": [_jwk(n, e, "kid-new")]}]
    calls = []

    def fetch():
        calls.append(1)
        return sets[0] if len(calls) == 1 else sets[1]

    v = rt.auth.JwksVerifier(fetch)
    tok = _rs256_sign(key, claims, kid="kid-new")
    out = [v.verify(tok), len(calls), v.verify(tok), len(calls)]
    reg = rt.session.SessionRegistry(authenticator=rt.auth.make_token_authenticator(verifier=v))

    async def flow():
        k = await reg.dispatch(rt.protocol.TextFrame("authentication", tok))
        return [reg.get(k).user_id,
                await aoutcome(reg.dispatch(rt.protocol.TextFrame("authentication", "garbage")))]

    out += run(flow())
    out += [outcome(functools.partial(rt.auth.make_token_authenticator, "sec", verifier=v)),
            outcome(rt.auth.make_token_authenticator)]
    google = rt.auth.make_google_verifier("client-1", fetch_jwks=lambda: sets[1])
    out.append([google.issuer, google.audience, google.verify(tok)])
    assert out[0]["email"] == "rot@b.com" and out[1] == 2 and out[4] == "rot@b.com"
    return out


def sc_dsl_fuzz_never_crashes_parser(rt):
    """1000 generated programs (valid grammar and mutated garbage): each
    parses, to the same calls in both packages, or raises DslError."""
    rng = random.Random(42)
    names = list(rt.actions.REGISTRY_NAMES)[:12] + ["unknown_fn"]
    parser = rt.dsl.Parser()

    def gen_expr(depth=0):
        r = rng.random()
        if depth > 2 or r < 0.5:
            return "|" + "".join(rng.choice("abc ") for _ in range(rng.randint(0, 6))) + "|"
        if r < 0.8:
            return gen_call(depth + 1)
        return gen_expr(depth + 1) + "^" + gen_expr(depth + 1)

    def gen_call(depth=0):
        return rng.choice(names) + "(" + ",".join(
            gen_expr(depth) for _ in range(rng.randint(0, 3))) + ")"

    out = []
    for i in range(1000):
        prog = "¬".join(gen_call() for _ in range(rng.randint(1, 4)))
        if i % 3 == 0:  # mutate into likely-garbage
            pos = rng.randrange(max(len(prog), 1))
            prog = prog[:pos] + rng.choice("()|^¬,x") + prog[pos + 1:]
        try:
            out.append(repr(parser.parse(prog)))
        except rt.dsl.DslError as e:
            out.append(("DslError", str(e)))
    assert sum(isinstance(o, tuple) for o in out) > 100
    return out


def sc_command_registry_keeps_caller_authenticator(rt):
    reg0 = rt.session.SessionRegistry(authenticator=rt.auth.make_token_authenticator("s"))
    reg = rt.commands.build_command_registry(rt.services.ServiceBundle(), registry=reg0)
    assert reg is reg0
    return outcome(reg.dispatch, rt.protocol.TextFrame("authentication", "garbage-token"))


def sc_personalization_crawler_batches_of_50(rt):
    bundle, reg = _bundle_registry(rt)

    async def flow():
        key = await _auth(rt, reg)
        crawler = rt.personalization.PersonalizationCrawler(key, reg.dispatch)
        docs = [f"doc {i}" for i in range(120)] + ["", "  ", None]  # blanks dropped
        batches = await crawler.upload(docs)
        small = rt.personalization.PersonalizationCrawler(key, reg.dispatch, batch_size=7)
        return [batches, crawler.uploaded_docs, await small.upload(docs[:20]),
                sorted(bundle.store.data.items())]

    out = run(flow())
    assert out[:2] == [3, 120] and out[3][0][1].count("summary:") == 6
    return out


def sc_wifi_qr_roundtrip(rt):
    p = rt.personalization
    payloads = [p.wifi_qr_payload('my;ssid:1', 'p,a"ss\\word'),
                p.wifi_qr_payload("cafe", "", security="nopass"),
                p.wifi_qr_payload("w", "k", security="WEP")]
    out = payloads + [p.parse_wifi_qr(x) for x in payloads] + [
        outcome(p.parse_wifi_qr, "HTTP://not-wifi"), outcome(p.parse_wifi_qr, "WIFI:T:WPA;;"),
        outcome(p.wifi_qr_payload, "x", "y", "WPA3")]
    assert out[3] == {"ssid": 'my;ssid:1', "password": 'p,a"ss\\word', "security": "WPA"}
    return out


def sc_jwks_bogus_kid_spray_is_throttled(rt):
    key, n, e = _rsa_keypair(0)
    calls = []
    current = {"keys": []}

    def fetch():
        calls.append(1)
        return current

    v = rt.auth.JwksVerifier(fetch, refresh_min_interval=60.0)
    claims = {"email": "a@b.c", "exp": EXP}
    out = [v.verify(_rs256_sign(key, claims, kid=f"bogus-{i}")) for i in range(25)]
    out.append(len(calls))  # the lazy load + ONE throttled refetch
    current = {"keys": [_jwk(n, e, "kid-rot")]}
    out.append(v.verify(_rs256_sign(key, claims, kid="kid-rot")))  # still throttled
    v._last_miss = time.monotonic() - 61.0
    out += [v.verify(_rs256_sign(key, claims, kid="kid-rot")), len(calls)]
    assert out[25] == 2 and out[26] is None and out[27]["email"] == "a@b.c"
    return out


SERVICES_SCENARIOS = [
    sc_all_reference_commands_registered, sc_onboarding_flow, sc_token_and_profile_commands,
    sc_media_and_maps_commands, sc_registry_matches_reference_names,
    sc_dsl_drives_actions_end_to_end, sc_calendar_update_delete, sc_tts_cache_per_user,
    sc_speak_command_hits_cache, sc_vision_decodes_real_image,
    sc_jwt_authenticator_accept_and_reject, sc_rs256_jwks_verifier,
    sc_rs256_jwks_rotation_and_authenticator, sc_dsl_fuzz_never_crashes_parser,
    sc_command_registry_keeps_caller_authenticator, sc_personalization_crawler_batches_of_50,
    sc_wifi_qr_roundtrip, sc_jwks_bogus_kid_spray_is_throttled,
]


def _ids(scenarios):
    return [s.__name__[3:] for s in scenarios]


@pytest.mark.parametrize("scenario", RUNTIME_SCENARIOS, ids=_ids(RUNTIME_SCENARIOS))
def test_runtime_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


@pytest.mark.parametrize("scenario", BATCHER_SCENARIOS, ids=_ids(BATCHER_SCENARIOS))
def test_batching_pipeline_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


@pytest.mark.parametrize("scenario", SERVICES_SCENARIOS, ids=_ids(SERVICES_SCENARIOS))
def test_services_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


# ---------------------------------------------------------------------------
# tests/test_product_journey.py through the port's service
# ---------------------------------------------------------------------------


JOURNEY_NAMES = ("DecodePipeline", "RingBuffer", "SessionRegistry", "Windower",
                 "build_command_registry", "parse_wifi_qr", "wifi_qr_payload", "WssService",
                 "ServiceBundle")
COMPANION_NAMES = ("CompanionClient", "Contact", "InMemoryBle", "InMemoryPhone",
                   "InProcessTransport", "PhoneActions", "Preferences", "is_online", "pair")
JOURNEYS = ["test_full_product_journey", "test_journey_rejects_streaming_before_auth"]


def _journey_run(rt, journey, where, monkeypatch, companion=None):
    """One journey of ``tests/test_product_journey.py`` with ``rt``'s runtime
    classes in place of the JAX package's, and with ``companion`` (a
    package's ``companion``) in place of the JAX companion, the device page
    the journey imports inside it included; returns what it leaves in the
    service (the decoded batch shapes, the store, the pipelines)."""
    import tests.test_product_journey as tj
    import imagined_speech_translation_tpu.companion as jax_companion
    import imagined_speech_translation_tpu.companion.webui as jax_webui

    services = []
    make_service = tj.make_service

    def recording(decoded_log):
        svc, bundle = make_service(decoded_log)
        services.append((svc, bundle, decoded_log))
        return svc, bundle

    with monkeypatch.context() as m:
        for name in JOURNEY_NAMES:
            for mod in (rt.pkg, rt.commands, rt.personalization, rt.server, rt.services):
                if hasattr(mod, name):
                    m.setattr(tj, name, getattr(mod, name))
                    break
        if companion is not None:
            for name in COMPANION_NAMES:
                m.setattr(tj, name, getattr(companion.ble if name == "pair" else companion, name))
            m.setattr(jax_companion, "DeviceUI", companion.DeviceUI)
            m.setattr(jax_webui, "serve", companion.webui.serve)
            assert tj.CompanionClient is companion.CompanionClient
        m.setattr(tj, "make_service", recording)
        assert tj.WssService is rt.server.WssService
        fn = getattr(tj, journey)
        fn(where) if "tmp_path" in inspect.signature(fn).parameters else fn()
    svc, bundle, decoded = services[0]
    return (decoded, sorted(bundle.store.data.items()), len(svc._pipelines),
            len(svc._actors), len(svc.registry))


@pytest.mark.parametrize("journey", JOURNEYS)
def test_product_journey_through_the_port_service(journey, tmp_path, monkeypatch):
    """The journey's own assertions hold with the port's runtime classes in
    place of the JAX package's, and what it leaves in the service (the
    decoded batch shapes, the store, the pipelines) equals the JAX run's."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _journey_run(PORT, journey, tmp_path / "port", monkeypatch)
    assert port == _journey_run(JAX, journey, tmp_path / "jax", monkeypatch)


@pytest.mark.parametrize("journey", JOURNEYS)
def test_product_journey_with_the_port_companion(journey, tmp_path, monkeypatch):
    """The same journey with the port's companion (client, BLE link, phone
    relays, preferences, WiFi liveness, the device page) driving the port's
    service, against the JAX companion driving the JAX service."""
    import imagined_speech_translation_tpu.companion as jax_companion
    import imagined_speech_translation_tpu_torch.companion as port_companion

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _journey_run(PORT, journey, tmp_path / "port", monkeypatch, port_companion)
    assert port == _journey_run(JAX, journey, tmp_path / "jax", monkeypatch, jax_companion)


# ---------------------------------------------------------------------------
# the copies' code and exports
# ---------------------------------------------------------------------------


def _stripped(module) -> ast.Module:
    """The module's AST without docstrings (comments never reach it)."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _code(module) -> str:
    return ast.dump(_stripped(module))


@pytest.mark.parametrize("name", MODULES)
def test_copied_module_code_is_the_original(name):
    assert _code(getattr(PORT, name)) == _code(getattr(JAX, name))


def test_runtime_package_exports_match():
    def exports(pkg):  # submodules imported elsewhere are no exports
        return {n for n in dir(pkg)
                if not n.startswith("_") and not inspect.ismodule(getattr(pkg, n))}

    assert exports(PORT.pkg) == exports(JAX.pkg)
    assert _code(PORT.pkg) == _code(JAX.pkg)


def test_port_imports_without_websockets():
    """Every port module imports where ``websockets`` is missing, as on the
    card's machine: only ``WssService.serve`` imports it."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['websockets'] = None  # any import of it raises\n"
        "import imagined_speech_translation_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert 'imagined_speech_translation_tpu_torch.runtime.server' in names\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
