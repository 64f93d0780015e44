"""Calendar reminder loop.

Reference: ``dart_wss`` spawns a per-user reminder isolate
(``dart_wss/lib/dart_wss.dart:118``, loop in ``lib/user.dart:255-315``) that
polls upcoming calendar events and speaks a reminder shortly before they
start.  Here it is an asyncio task per session, testable with injected
clocks.

A copy of ``imagined_speech_translation_tpu.runtime.reminders`` (it imports
no jax), so the port imports nothing of the JAX package; a test holds its
code to the original's.
"""

from __future__ import annotations

import asyncio
import time
from datetime import datetime
from typing import Awaitable, Callable


def _parse_start(value: str) -> float | None:
    try:
        return datetime.fromisoformat(value).timestamp()
    except (ValueError, TypeError):
        return None


class ReminderLoop:
    def __init__(
        self,
        personal,
        announce: Callable[[str], Awaitable[None]],
        *,
        lead_seconds: float = 300.0,
        poll_seconds: float = 60.0,
        clock: Callable[[], float] = time.time,
    ):
        self.personal = personal
        self.announce = announce
        self.lead = lead_seconds
        self.poll = poll_seconds
        self.clock = clock
        self._announced: set[str] = set()
        self._task: asyncio.Task | None = None

    async def check_once(self) -> list[str]:
        """One poll; returns the events announced this cycle."""
        now = self.clock()
        fired = []
        for ev in await self.personal.list_events():
            start = _parse_start(ev.get("start", ""))
            if start is None or ev["id"] in self._announced:
                continue
            if 0 <= start - now <= self.lead:
                await self.announce(
                    f"提醒：{ev['title']} 将于 {ev['start']} 开始"
                )
                self._announced.add(ev["id"])
                fired.append(ev["id"])
        return fired

    async def _run(self):
        while True:
            try:
                await self.check_once()
            except Exception:
                pass
            await asyncio.sleep(self.poll)

    def start(self) -> asyncio.Task:
        self._task = asyncio.get_event_loop().create_task(self._run())
        return self._task

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None
