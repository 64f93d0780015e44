"""Per-user session registry + command dispatch.

Reference: ``wss/wss.js:43-83`` keeps a Map of per-access-key ``Session``
objects and gates all commands behind authentication (only
``authentication¬<idToken>`` is accepted for unknown keys); each session
dispatches ~15 command handlers (``wss/wss.js:52-68``).  The reference's
cross-worker session-affinity bug (sessions held per cluster worker,
SURVEY.md §5) disappears here: one registry per process, guarded by a lock.

A copy of ``imagined_speech_translation_tpu.runtime.session`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from .protocol import TextFrame

Handler = Callable[["Session", tuple[str, ...]], Awaitable[Any]]


@dataclass
class Session:
    access_key: str
    user_id: str = ""
    created_at: float = field(default_factory=time.time)
    state: dict[str, Any] = field(default_factory=dict)
    authenticated: bool = False

    def touch(self) -> None:
        self.state["last_seen"] = time.time()


class SessionRegistry:
    """Auth-gated command dispatch over sessions."""

    AUTH_COMMAND = "authentication"

    def __init__(
        self,
        *,
        authenticator: Callable[[str], Awaitable[str | None]] | None = None,
    ):
        self._sessions: dict[str, Session] = {}
        self._handlers: dict[str, Handler] = {}
        self._lock = asyncio.Lock()
        # authenticator maps an id token -> user id (or None to reject);
        # reference verifies a Google id token (wss/func/auth.js:14-19)
        self._authenticator = authenticator or _accept_all

    # ------------------------------------------------------------------
    def command(self, name: str):
        """Decorator registering a command handler."""

        def wrap(fn: Handler) -> Handler:
            self._handlers[name] = fn
            return fn

        return wrap

    def register(self, name: str, fn: Handler) -> None:
        self._handlers[name] = fn

    def get(self, access_key: str) -> Session | None:
        return self._sessions.get(access_key)

    def __len__(self) -> int:
        return len(self._sessions)

    # ------------------------------------------------------------------
    async def authenticate(self, id_token: str) -> Session | None:
        user = await self._authenticator(id_token)
        if user is None:
            return None
        async with self._lock:
            key = secrets.token_hex(16)
            session = Session(access_key=key, user_id=user, authenticated=True)
            self._sessions[key] = session
        return session

    async def dispatch(self, frame: TextFrame) -> Any:
        """Route a frame: unauthenticated keys may only authenticate
        (reference auth gate, wss/wss.js:48-83)."""
        if frame.command == self.AUTH_COMMAND:
            token = frame.access_key or (frame.args[0] if frame.args else "")
            session = await self.authenticate(token)
            if session is None:
                raise PermissionError("authentication failed")
            return session.access_key

        session = self._sessions.get(frame.access_key)
        if session is None or not session.authenticated:
            raise PermissionError(f"unknown access key for {frame.command!r}")
        handler = self._handlers.get(frame.command)
        if handler is None:
            raise KeyError(f"unknown command {frame.command!r}")
        session.touch()
        return await handler(session, frame.args)

    async def drop(self, access_key: str) -> None:
        async with self._lock:
            self._sessions.pop(access_key, None)


async def _accept_all(token: str) -> str | None:
    return token or None
