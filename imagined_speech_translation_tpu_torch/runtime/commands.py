"""The control-plane command table.

Reference: the 15 commands dispatched per session by the Node server
(``wss/wss.js:52-68``): first_time, ble_id, auth_code, get_auth_code,
get_refresh_token, get_display_name, add_query, not_first_time, speak,
process, vision, directions, get_place, stream_song, send_data — implemented
against the :class:`~.services.ServiceBundle` and registered on a
:class:`~.session.SessionRegistry`.

A copy of ``imagined_speech_translation_tpu.runtime.commands`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import base64

from .services import ServiceBundle
from .session import Session, SessionRegistry


def build_command_registry(
    services: ServiceBundle,
    *,
    registry: SessionRegistry | None = None,
) -> SessionRegistry:
    # NOT `registry or ...`: SessionRegistry defines __len__, so an empty
    # (zero-session) registry is falsy and would be silently replaced —
    # dropping the caller's authenticator.
    reg = registry if registry is not None else SessionRegistry()
    store = services.store

    def skey(session: Session, name: str) -> str:
        return f"{name}:{session.user_id or session.access_key}"

    # -- onboarding / profile -------------------------------------------
    @reg.command("first_time")
    async def first_time(session, args):
        # pure READ (reference: session.js:15-18 queries first_time without
        # writing); only not_first_time flips the flag (session.js:77-79) —
        # writing here would forfeit the one-shot personalization upload
        # for clients that sign in before their corpus is ready
        seen = await store.get(skey(session, "seen"))
        return {"first_time": not bool(seen)}

    @reg.command("not_first_time")
    async def not_first_time(session, args):
        await store.set(skey(session, "seen"), True)
        return {"first_time": False}

    @reg.command("ble_id")
    async def ble_id(session, args):
        if args:
            await store.set(skey(session, "ble"), args[0])
            return {"ble_id": args[0]}
        return {"ble_id": await store.get(skey(session, "ble"))}

    # -- oauth-ish token plumbing (reference: session.js:26-55) ----------
    @reg.command("auth_code")
    async def auth_code(session, args):
        # code -> refresh-token exchange; local implementation derives a
        # deterministic opaque token
        code = args[0] if args else ""
        refresh = "rt_" + base64.urlsafe_b64encode(code.encode()).decode()
        await store.set(skey(session, "refresh"), refresh)
        return {"stored": True}

    @reg.command("get_auth_code")
    async def get_auth_code(session, args):
        return {"auth_code": await store.get(skey(session, "auth_code"))}

    @reg.command("get_refresh_token")
    async def get_refresh_token(session, args):
        return {"refresh_token": await store.get(skey(session, "refresh"))}

    @reg.command("get_display_name")
    async def get_display_name(session, args):
        name = await store.get(skey(session, "name"))
        return {"display_name": name or session.user_id}

    # -- personalization (reference: session.js:66-75) -------------------
    @reg.command("add_query")
    async def add_query(session, args):
        data = args[0] if args else ""
        summary = await services.llm.generate(f"summarize user data: {data}")
        prev = await store.get(skey(session, "profile")) or ""
        await store.set(skey(session, "profile"), (prev + "\n" + summary).strip())
        return {"stored_chars": len(data)}

    # -- conversation ----------------------------------------------------
    @reg.command("process")
    async def process(session, args):
        return {"response": await services.llm.chat(session.access_key, args[0])}

    @reg.command("send_data")
    async def send_data(session, args):
        profile = await store.get(skey(session, "profile"))
        text = args[0] if args else ""
        prompt = f"{profile}\n{text}" if profile else text
        return {"response": await services.llm.chat(session.access_key, prompt)}

    @reg.command("vision")
    async def vision(session, args):
        # base64 image + prompt -> multimodal LLM call on the decoded bytes
        # (reference: inlineData base64 image to Gemini, session.js:114-124)
        image_b64 = args[0] if args else ""
        prompt = args[1] if len(args) > 1 else "describe"
        try:
            image = base64.b64decode(image_b64, validate=True)
        except Exception:
            return {"error": "invalid base64 image"}
        return {"response": await services.llm.describe_image(image, prompt)}

    # -- speech / media ---------------------------------------------------
    @reg.command("speak")
    async def speak(session, args):
        # per-user TTS cache (reference: audio.js:23-82 caches per key)
        pcm = await services.tts.synthesize(
            args[0] if args else "", session.user_id or session.access_key
        )
        return {"pcm_bytes": len(pcm)}

    @reg.command("stream_song")
    async def stream_song(session, args):
        audio = await services.music.stream(args[0] if args else "")
        return {"audio_bytes": len(audio)}

    # -- maps --------------------------------------------------------------
    @reg.command("directions")
    async def directions(session, args):
        origin = args[0] if args else ""
        dest = args[1] if len(args) > 1 else ""
        return {"steps": await services.maps.directions(origin, dest)}

    @reg.command("get_place")
    async def get_place(session, args):
        return {"place": await services.maps.find_place(args[0] if args else "")}

    return reg


#: command names for parity checks (wss/wss.js:52-68)
COMMAND_NAMES = (
    "first_time", "ble_id", "auth_code", "get_auth_code", "get_refresh_token",
    "get_display_name", "add_query", "not_first_time", "speak", "process",
    "vision", "directions", "get_place", "stream_song", "send_data",
)
