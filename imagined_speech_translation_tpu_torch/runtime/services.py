"""Pluggable external-service interfaces + local in-memory implementations.

The reference's serving stack calls Google cloud services directly (Gemini
LLM, TTS, Maps, Firestore, Gmail/Calendar/Tasks/Docs/Sheets/Drive —
``wss/func/*.js``, ``dart_wss/lib/user.dart``).  Those are environment
bindings, not framework logic; here each becomes a small interface so
deployments plug real backends while tests and offline use get functional
in-memory fakes.  The command plane (commands.py) and the DSL action
registry (actions.py) depend only on these interfaces.

A copy of ``imagined_speech_translation_tpu.runtime.services`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Protocol


# ---------------------------------------------------------------------------
# interfaces
# ---------------------------------------------------------------------------


class LLMService(Protocol):
    """Chat + one-shot generation + image understanding (reference: Gemini
    via wss/func/model.js; base64-image vision call session.js:114-124)."""

    async def chat(self, session_id: str, prompt: str) -> str: ...
    async def generate(self, prompt: str) -> str: ...
    async def describe_image(self, image: bytes, prompt: str) -> str: ...


class TTSService(Protocol):
    """Text → PCM bytes (reference: Google TTS, wss/func/audio.js).

    ``user`` keys the per-user cache (audio.js caches WAV per access key)."""

    async def synthesize(self, text: str, user: str = "") -> bytes: ...


class STTService(Protocol):
    async def transcribe(self, audio: bytes) -> str: ...


class MapsService(Protocol):
    async def directions(self, origin: str, destination: str) -> list[str]: ...
    async def find_place(self, query: str, near: str | None = None) -> dict: ...


class MusicService(Protocol):
    async def stream(self, query: str) -> bytes: ...


class KeyValueStore(Protocol):
    """Auth-key/profile persistence (reference: Firestore, wss/func/db.js)."""

    async def get(self, key: str) -> Any: ...
    async def set(self, key: str, value: Any) -> None: ...
    async def find(self, field_name: str, value: Any) -> dict | None: ...


class PersonalDataService(Protocol):
    """Calendar / tasks / mail / docs / sheets / drive / contacts
    (reference: dart_wss/lib/user.dart Google API calls)."""

    async def list_events(self, day: str | None = None) -> list[dict]: ...
    async def add_event(self, title: str, start: str, end: str) -> dict: ...
    async def update_event(self, event_id: str, **fields) -> dict: ...
    async def delete_event(self, event_id: str) -> bool: ...
    async def list_tasks(self) -> list[dict]: ...
    async def add_task(self, title: str, due: str | None = None) -> dict: ...
    async def update_task(self, task_id: str, **fields) -> dict: ...
    async def delete_task(self, task_id: str) -> bool: ...
    async def read_email(self, email_id: str) -> dict: ...
    async def search_emails(self, query: str) -> list[dict]: ...
    async def send_email(self, to: str, subject: str, body: str) -> dict: ...
    async def reply_email(self, email_id: str, body: str) -> dict: ...
    async def get_document(self, name: str) -> str: ...
    async def write_document(self, name: str, content: str) -> dict: ...
    async def get_sheet(self, name: str) -> list[list[str]]: ...
    async def write_sheet(self, name: str, rows: list[list[str]]) -> dict: ...
    async def contacts(self) -> list[dict]: ...


# ---------------------------------------------------------------------------
# local implementations (offline / tests)
# ---------------------------------------------------------------------------


class EchoLLM:
    """Deterministic local LLM stand-in: echoes through the DSL shape the
    real LLM is prompted to produce (speak(|...|))."""

    def __init__(self):
        self.history: dict[str, list[str]] = {}

    async def chat(self, session_id: str, prompt: str) -> str:
        self.history.setdefault(session_id, []).append(prompt)
        return f"speak(|{prompt}|)"

    async def generate(self, prompt: str) -> str:
        return f"summary:{prompt[:64]}"

    async def describe_image(self, image: bytes, prompt: str) -> str:
        """Deterministic image 'understanding': parses real PNG/JPEG headers
        so the vision path is exercised on actual bytes, not a string stub."""
        kind, w, h = _image_info(image)
        return f"[{kind} {w}x{h}, {len(image)}B] {prompt}"


def _image_info(data: bytes) -> tuple[str, int, int]:
    """(format, width, height) from PNG/JPEG headers; ('raw', 0, 0) else."""
    if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
        w = int.from_bytes(data[16:20], "big")
        h = int.from_bytes(data[20:24], "big")
        return "png", w, h
    if data[:2] == b"\xff\xd8":  # JPEG: scan for a SOFn marker
        i = 2
        while i + 9 < len(data):
            if data[i] != 0xFF:
                break
            marker = data[i + 1]
            size = int.from_bytes(data[i + 2 : i + 4], "big")
            if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
                h = int.from_bytes(data[i + 5 : i + 7], "big")
                w = int.from_bytes(data[i + 7 : i + 9], "big")
                return "jpeg", w, h
            i += 2 + size
        return "jpeg", 0, 0
    return "raw", 0, 0


class SilentTTS:
    """16-bit PCM of silence sized to the text (deterministic, testable)."""

    sample_rate = 24000

    async def synthesize(self, text: str, user: str = "") -> bytes:
        n = max(len(text) * 240, 240)
        return b"\x00\x00" * n


class CachingTTS:
    """Per-user synthesis cache (reference: ``wss/func/audio.js:23-82``
    caches the synthesized WAV under ``./audio/<access_key>/``).

    Wraps any TTSService; repeated texts per user return the cached PCM
    without touching the backend.  ``cache_info()`` exposes hit/miss counts."""

    def __init__(self, inner: Any = None, *, max_entries_per_user: int = 256):
        # not `inner or ...`: a falsy (__len__-defining) service would be
        # silently replaced (same bug class as build_command_registry's fix)
        self.inner = inner if inner is not None else SilentTTS()
        self.max_entries_per_user = max_entries_per_user
        self._cache: dict[str, dict[str, bytes]] = {}
        self.hits = 0
        self.misses = 0

    async def synthesize(self, text: str, user: str = "") -> bytes:
        per_user = self._cache.setdefault(user, {})
        if text in per_user:
            self.hits += 1
            return per_user[text]
        self.misses += 1
        pcm = await self.inner.synthesize(text, user)
        if len(per_user) >= self.max_entries_per_user:
            per_user.pop(next(iter(per_user)))  # FIFO eviction
        per_user[text] = pcm
        return pcm

    def cache_info(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "users": len(self._cache),
        }


class EchoSTT:
    async def transcribe(self, audio: bytes) -> str:
        return f"<audio:{len(audio)}b>"


class StaticMaps:
    async def directions(self, origin: str, destination: str) -> list[str]:
        return [f"Head from {origin}", f"Arrive at {destination}"]

    async def find_place(self, query: str, near: str | None = None) -> dict:
        return {"name": query, "address": f"1 {query} Way", "rating": 4.5}


class SilentMusic:
    async def stream(self, query: str) -> bytes:
        return b"\x00" * 1024


class MemoryStore:
    def __init__(self):
        self.data: dict[str, Any] = {}

    async def get(self, key):
        return self.data.get(key)

    async def set(self, key, value):
        self.data[key] = value

    async def find(self, field_name, value):
        for k, v in self.data.items():
            if isinstance(v, dict) and v.get(field_name) == value:
                return {"key": k, **v}
        return None


class MemoryPersonalData:
    """In-memory calendar/tasks/mail/docs/sheets/contacts."""

    def __init__(self):
        self._id = 0
        self.events: dict[str, dict] = {}
        self.tasks: dict[str, dict] = {}
        self.emails: dict[str, dict] = {}
        self.docs: dict[str, str] = {}
        self.sheets: dict[str, list[list[str]]] = {}
        self.contact_list: list[dict] = []

    def _next(self, prefix: str) -> str:
        self._id += 1
        return f"{prefix}{self._id}"

    async def list_events(self, day=None):
        evs = list(self.events.values())
        if day:
            evs = [e for e in evs if e["start"].startswith(day)]
        return evs

    async def add_event(self, title, start, end):
        eid = self._next("ev")
        self.events[eid] = {"id": eid, "title": title, "start": start, "end": end}
        return self.events[eid]

    async def update_event(self, event_id, **fields):
        self.events[event_id].update(fields)
        return self.events[event_id]

    async def delete_event(self, event_id):
        return self.events.pop(event_id, None) is not None

    async def list_tasks(self):
        return list(self.tasks.values())

    async def add_task(self, title, due=None):
        tid = self._next("t")
        self.tasks[tid] = {"id": tid, "title": title, "due": due, "done": False}
        return self.tasks[tid]

    async def update_task(self, task_id, **fields):
        self.tasks[task_id].update(fields)
        return self.tasks[task_id]

    async def delete_task(self, task_id):
        return self.tasks.pop(task_id, None) is not None

    async def read_email(self, email_id):
        return self.emails[email_id]

    async def search_emails(self, query):
        return [
            e for e in self.emails.values()
            if query in e.get("subject", "") or query in e.get("body", "")
        ]

    async def send_email(self, to, subject, body):
        eid = self._next("m")
        self.emails[eid] = {
            "id": eid, "to": to, "subject": subject, "body": body,
            "ts": time.time(),
        }
        return self.emails[eid]

    async def reply_email(self, email_id, body):
        orig = self.emails[email_id]
        return await self.send_email(
            orig.get("to", ""), "Re: " + orig.get("subject", ""), body
        )

    async def get_document(self, name):
        return self.docs.get(name, "")

    async def write_document(self, name, content):
        self.docs[name] = content
        return {"name": name, "length": len(content)}

    async def get_sheet(self, name):
        return self.sheets.get(name, [])

    async def write_sheet(self, name, rows):
        self.sheets[name] = rows
        return {"name": name, "rows": len(rows)}

    async def contacts(self):
        return list(self.contact_list)


@dataclass
class ServiceBundle:
    """Everything the command plane and action registry need."""

    llm: Any = field(default_factory=EchoLLM)
    tts: Any = field(default_factory=CachingTTS)
    stt: Any = field(default_factory=EchoSTT)
    maps: Any = field(default_factory=StaticMaps)
    music: Any = field(default_factory=SilentMusic)
    store: Any = field(default_factory=MemoryStore)
    personal: Any = field(default_factory=MemoryPersonalData)
