"""The DSL action registry — the function surface the LLM drives.

Reference: ``dart_wss/lib/dart_wss.dart:65-100`` registers 33 user actions
(speech, camera, routes, docs/sheets, volume, music, contacts/call/text,
calendar CRUD, email, tasks, places) executed by the DSL parser against a
per-user ``User`` object (``dart_wss/lib/user.dart``).  Here the registry is
built from a :class:`~.services.ServiceBundle` plus a device channel, so the
same function names work against real or in-memory backends.

A copy of ``imagined_speech_translation_tpu.runtime.actions`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from .services import ServiceBundle


@dataclass
class DeviceChannel:
    """Messages destined for the edge device (glasses): audio, volume,
    camera commands... (the reference relays these over the device socket,
    dart_wss/lib/user.dart).  Collected here; a server binds ``send`` to the
    actual websocket."""

    sent: list[tuple[str, Any]] = field(default_factory=list)
    send: Callable[[str, Any], Awaitable[None]] | None = None

    async def emit(self, kind: str, payload: Any) -> None:
        self.sent.append((kind, payload))
        if self.send is not None:
            await self.send(kind, payload)


class UserActions:
    """Per-user action implementations (reference: the ``User`` class,
    dart_wss/lib/user.dart)."""

    def __init__(
        self,
        services: ServiceBundle,
        device: DeviceChannel | None = None,
        *,
        user_id: str = "",
    ):
        self.services = services
        self.device = device or DeviceChannel()
        self.user_id = user_id
        self.recording = False
        self.speed_recording = False
        self.route_active: str | None = None
        self.volume = 50

    # -- conversation / audio ------------------------------------------
    async def process(self, text: str) -> str:
        return await self.services.llm.chat(self.user_id, text)

    async def send_data(self, text: str) -> str:
        profile = await self.services.store.get(f"profile:{self.user_id}")
        prompt = f"{profile}\n{text}" if profile else text
        return await self.services.llm.chat(self.user_id, prompt)

    async def speak(self, text: str) -> str:
        # user keys the per-user TTS cache (audio.js caches per access key)
        pcm = await self.services.tts.synthesize(text, self.user_id)
        await self.device.emit("audio", pcm)
        return text

    async def listen(self) -> str:
        await self.device.emit("listen", None)
        return "listening"

    # -- camera / media -------------------------------------------------
    async def take_picture(self) -> str:
        await self.device.emit("take_picture", None)
        return "picture_requested"

    async def start_recording(self) -> str:
        self.recording = True
        await self.device.emit("record_video", None)
        return "recording"

    async def stop_recording(self) -> str:
        self.recording = False
        await self.device.emit("stop_recording", None)
        return "stopped"

    # -- navigation ------------------------------------------------------
    async def start_route(self, destination: str) -> str:
        self.route_active = destination
        steps = await self.services.maps.directions("current location", destination)
        await self.device.emit("route", steps)
        return "; ".join(steps)

    async def stop_route(self) -> str:
        self.route_active = None
        return "route_stopped"

    async def get_place(self, query: str) -> str:
        place = await self.services.maps.find_place(query)
        return f"{place['name']} at {place['address']}"

    # -- docs / sheets ---------------------------------------------------
    async def get_document(self, name: str) -> str:
        return await self.services.personal.get_document(name)

    async def write_document(self, name: str, content: str) -> str:
        out = await self.services.personal.write_document(name, content)
        return f"wrote {out['length']} chars to {name}"

    async def get_sheet(self, name: str) -> str:
        rows = await self.services.personal.get_sheet(name)
        return "\n".join(",".join(r) for r in rows)

    async def write_sheet(self, name: str, content: str) -> str:
        rows = [r.split(",") for r in content.splitlines() if r]
        out = await self.services.personal.write_sheet(name, rows)
        return f"wrote {out['rows']} rows to {name}"

    # -- device controls -------------------------------------------------
    async def change_volume(self, level: str) -> str:
        self.volume = max(0, min(100, int(float(level))))
        await self.device.emit("volume", self.volume)
        return f"volume {self.volume}"

    async def wait(self, seconds: str) -> str:
        await asyncio.sleep(min(float(seconds), 10.0))
        return f"waited {seconds}"

    async def record_speed(self) -> str:
        self.speed_recording = True
        await self.device.emit("record_speed", None)
        return "speed_recording"

    async def stop_speed(self) -> str:
        self.speed_recording = False
        return "speed_stopped"

    async def play_song(self, query: str) -> str:
        audio = await self.services.music.stream(query)
        await self.device.emit("play", audio)
        return f"playing {query}"

    # -- contacts / phone relays ----------------------------------------
    async def contacts(self) -> str:
        people = await self.services.personal.contacts()
        return "; ".join(p.get("name", "?") for p in people)

    async def call(self, who: str) -> str:
        await self.device.emit("call", who)
        return f"calling {who}"

    async def text(self, who: str, message: str) -> str:
        await self.device.emit("text", {"to": who, "message": message})
        return f"texted {who}"

    # -- calendar --------------------------------------------------------
    async def get_calendar_events(self, day: str = "") -> str:
        evs = await self.services.personal.list_events(day or None)
        return "; ".join(f"{e['title']} @ {e['start']}" for e in evs) or "no events"

    async def add_calendar_event(self, title: str, start: str, end: str) -> str:
        ev = await self.services.personal.add_event(title, start, end)
        return ev["id"]

    async def update_calendar_event(self, event_id: str, title: str) -> str:
        ev = await self.services.personal.update_event(event_id, title=title)
        return ev["id"]

    async def delete_calendar_event(self, event_id: str) -> str:
        ok = await self.services.personal.delete_event(event_id)
        return "deleted" if ok else "not_found"

    # -- email -----------------------------------------------------------
    async def read_email(self, email_id: str) -> str:
        mail = await self.services.personal.read_email(email_id)
        return f"{mail.get('subject', '')}: {mail.get('body', '')}"

    async def search_emails(self, query: str) -> str:
        found = await self.services.personal.search_emails(query)
        return "; ".join(m["id"] for m in found) or "none"

    async def reply_email(self, email_id: str, body: str) -> str:
        out = await self.services.personal.reply_email(email_id, body)
        return out["id"]

    async def send_email(self, to: str, subject: str, body: str) -> str:
        out = await self.services.personal.send_email(to, subject, body)
        return out["id"]

    # -- tasks -----------------------------------------------------------
    async def get_tasks(self) -> str:
        tasks = await self.services.personal.list_tasks()
        return "; ".join(t["title"] for t in tasks) or "no tasks"

    async def add_task(self, title: str, due: str = "") -> str:
        t = await self.services.personal.add_task(title, due or None)
        return t["id"]

    async def update_task(self, task_id: str, title: str) -> str:
        t = await self.services.personal.update_task(task_id, title=title)
        return t["id"]

    async def delete_task(self, task_id: str) -> str:
        ok = await self.services.personal.delete_task(task_id)
        return "deleted" if ok else "not_found"


#: the reference registry names (dart_wss/lib/dart_wss.dart:65-100)
REGISTRY_NAMES = (
    "process", "send_data", "speak", "listen", "take_picture",
    "start_recording", "stop_recording", "start_route", "stop_route",
    "get_document", "write_document", "get_sheet", "write_sheet",
    "change_volume", "wait", "record_speed", "stop_speed", "play_song",
    "contacts", "call", "text", "get_calendar_events", "add_calendar_event",
    "delete_calendar_event", "update_calendar_event", "read_email",
    "search_emails", "reply_email", "send_email", "get_tasks", "add_task",
    "update_task", "delete_task", "get_place",
)


def build_action_registry(actions: UserActions) -> dict:
    """Name → bound method map for the DSL parser."""
    registry = {name: getattr(actions, name) for name in REGISTRY_NAMES}
    return registry
