"""Client transports for the ``¬`` control-plane protocol.

The reference app talks to the cloud plane through one singleton websocket
(``app/lib/helper/socket.dart``) with a strict request/response discipline:
send a frame, await the next reply (``sign_in.dart:112-121``).  Here the
transport is an interface so the same :class:`~.client.CompanionClient`
drives a real websocket, or the in-process
:class:`~..runtime.server.WssService` directly (tests, embedded hosts).

A copy of ``imagined_speech_translation_tpu.companion.transport`` (it
imports no jax), so the port imports nothing of the JAX package; a test
holds its code to the original's.
"""

from __future__ import annotations

from typing import Protocol


class Transport(Protocol):
    async def send(self, message: str) -> None: ...

    async def receive(self) -> str: ...

    async def close(self) -> None: ...


class InProcessTransport:
    """Drives a :class:`WssService` without a socket.

    ``handle_text`` is synchronous request->reply, so replies are queued in
    send order — the same ordering guarantee a single websocket gives the
    app.  Utterance frames (binary-path byproducts) don't occur on this
    text-only path.
    """

    def __init__(self, service):
        self._service = service
        self._replies: list[str] = []

    async def send(self, message: str) -> None:
        self._replies.append(await self._service.handle_text(message))

    async def receive(self) -> str:
        if not self._replies:
            raise RuntimeError("no pending reply; send a frame first")
        return self._replies.pop(0)

    async def close(self) -> None:
        self._replies.clear()


class WebsocketTransport:
    """Lazy-connecting websocket transport (the app's singleton socket)."""

    def __init__(self, url: str):
        self.url = url
        self._ws = None

    async def _ensure(self):
        if self._ws is None:
            import websockets

            self._ws = await websockets.connect(self.url, max_size=None)
        return self._ws

    async def send(self, message: str) -> None:
        ws = await self._ensure()
        await ws.send(message)

    async def receive(self) -> str:
        ws = await self._ensure()
        msg = await ws.recv()
        if isinstance(msg, bytes):
            msg = msg.decode()
        return msg

    async def close(self) -> None:
        if self._ws is not None:
            await self._ws.close()
            self._ws = None
