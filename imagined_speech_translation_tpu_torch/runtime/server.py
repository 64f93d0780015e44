"""Websocket service speaking the reference's two framings.

Reference topology: a Node control-plane server (``wss/wss.js``, port 443,
``¬`` text frames) and a Dart device server (``dart_wss``, port 4040,
``|``-delimited binary frames) — merged here into one asyncio websocket
service: text messages hit the session registry's command table; binary
messages route device streams (EEG samples → DecodePipeline per session).

Run: ``python -m imagined_speech_translation_tpu_torch.runtime.server --port 4040``
(the command table over in-memory services, no decode pipeline; the
serving CLI ``cli.serve`` wires the decode pipeline).  ``websockets`` is
imported only inside :meth:`WssService.serve`.

A copy of ``imagined_speech_translation_tpu.runtime.server`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py`` holds
the copy to the original.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Callable

import numpy as np

from .protocol import (
    BinaryFrame,
    TextFrame,
    decode_binary_frame,
    decode_text_frame,
    encode_text_frame,
)
from .session import SessionRegistry
from .streaming import DecodePipeline

logger = logging.getLogger(__name__)


async def _maybe_await(result):
    """Pipelines may be sync (:class:`DecodePipeline`) or async (the
    cross-session :class:`~.batcher.BatchingDecodePipeline`)."""
    if asyncio.iscoroutine(result):
        return await result
    return result


class WssService:
    def __init__(
        self,
        registry: SessionRegistry,
        *,
        pipeline_factory: Callable[[str], DecodePipeline] | None = None,
        n_channels: int = 48,
        services=None,
    ):
        self.registry = registry
        self.pipeline_factory = pipeline_factory
        self.n_channels = n_channels
        self.services = services
        self._pipelines: dict[str, DecodePipeline] = {}
        self._actors: dict[str, tuple] = {}  # key -> (UserActions, Parser)

    # ------------------------------------------------------------------
    async def handle_text(self, message: str) -> str:
        try:
            frame = decode_text_frame(message)
            result = await self.registry.dispatch(frame)
            return encode_text_frame(
                TextFrame("ok", frame.command, (json.dumps(result, default=str),))
            )
        except PermissionError as e:
            return encode_text_frame(TextFrame("error", "auth", (str(e),)))
        except Exception as e:  # protocol errors back to the client
            return encode_text_frame(TextFrame("error", "bad_request", (str(e),)))

    async def handle_binary(self, data: bytes) -> list[str]:
        """Returns decoded utterance texts (if any) for ``eeg`` frames."""
        frame = decode_binary_frame(data)
        session = self.registry.get(frame.auth_key)
        if session is None:
            raise PermissionError("unknown auth key")
        if frame.command == "eeg":
            pipe = self._pipeline_for(frame.auth_key)
            samples = np.frombuffer(frame.payload, np.float32).reshape(
                self.n_channels, -1
            )
            return await _maybe_await(pipe.feed(samples))
        if frame.command == "eeg_end":
            pipe = self._pipeline_for(frame.auth_key)
            return await _maybe_await(pipe.flush())
        if frame.command in ("audio", "speech_to_text"):
            # the conversational loop (SURVEY.md §3.5): device audio → STT →
            # LLM → function-call DSL executed against the action registry
            return await self._converse_audio(session, frame.payload)
        raise KeyError(f"unknown binary command {frame.command!r}")

    async def _converse_audio(self, session, audio: bytes) -> list[str]:
        if self.services is None:
            raise RuntimeError("no service bundle configured for audio")
        text = await self.services.stt.transcribe(audio)
        return await self.converse_text(session, text)

    async def converse_text(self, session, text: str) -> list[str]:
        """Text → LLM → DSL program → executed actions; returns results."""
        if self.services is None:
            raise RuntimeError("no service bundle configured")
        actions, parser = self._actor_for(session)
        program = await actions.send_data(text)
        try:
            results = await parser.execute(program)
        except Exception as e:
            logger.warning("DSL execution failed: %s (program=%r)", e, program)
            # graceful degradation: speak the raw LLM output
            results = [await actions.speak(program)]
        return [str(r) for r in results]

    def _actor_for(self, session):
        key = session.access_key
        if key not in self._actors:
            from .actions import UserActions, build_action_registry
            from .dsl import Parser

            actions = UserActions(self.services, user_id=session.user_id)
            parser = Parser(build_action_registry(actions))
            self._actors[key] = (actions, parser)
        return self._actors[key]

    def _pipeline_for(self, key: str) -> DecodePipeline:
        if key not in self._pipelines:
            if self.pipeline_factory is None:
                raise RuntimeError("no decode pipeline configured")
            self._pipelines[key] = self.pipeline_factory(key)
        return self._pipelines[key]

    # ------------------------------------------------------------------
    async def serve(self, host: str, port: int):
        import websockets

        async def handler(ws):
            async for message in ws:
                if isinstance(message, bytes):
                    try:
                        texts = await self.handle_binary(message)
                        for t in texts:
                            await ws.send(
                                encode_text_frame(TextFrame("utterance", "", (t,)))
                            )
                    except Exception as e:
                        await ws.send(
                            encode_text_frame(TextFrame("error", "stream", (str(e),)))
                        )
                else:
                    await ws.send(await self.handle_text(message))

        async with websockets.serve(handler, host, port):
            logger.info("wss service on %s:%d", host, port)
            await asyncio.Future()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=4040)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # full reference command table over the in-memory service bundle — the
    # same 15-command control plane the Node server exposes (wss/wss.js:52-68)
    from .commands import build_command_registry
    from .services import ServiceBundle

    bundle = ServiceBundle()
    service = WssService(build_command_registry(bundle), services=bundle)
    asyncio.run(service.serve(args.host, args.port))


if __name__ == "__main__":
    main()
