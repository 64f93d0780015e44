"""Real cloud-backend adapters for the service interfaces.

The reference binds its serving plane to concrete Google endpoints — Gemini
``generateContent`` chat with a persistent history and an inline base64 image
for vision (``wss/func/model.js:11-57``, ``wss/func/session.js:114-124``),
Cloud Text-to-Speech LINEAR16 WAV parsed to PCM (``wss/func/audio.js:23-82``),
Cloud Speech-to-Text (``dart_wss/lib/user.dart:73``), and the Maps Places /
Directions web APIs (``wss/func/google_maps.js:18-93``).

These adapters implement the :mod:`.services` protocols against the SAME
wire formats, with the HTTP transport injected (``http(method, url, json=...,
headers=...) -> (status, body_bytes)``) so they are testable offline and
swappable onto ``aiohttp``/``httpx`` in deployment.  They are the proof that
the in-memory fakes' interfaces fit the real backends: request/response
mapping is exercised against the documented API shapes in
``tests/test_runtime_adapters.py``.

A copy of ``imagined_speech_translation_tpu.runtime.adapters`` (it imports
no jax), so the port imports nothing of the JAX package; a test holds its
code to the original's.
"""

from __future__ import annotations

import base64
import json
from typing import Awaitable, Callable, Tuple

HttpFn = Callable[..., Awaitable[Tuple[int, bytes]]]


class CloudError(RuntimeError):
    """Non-2xx response from a cloud backend."""

    def __init__(self, service: str, status: int, body: bytes):
        super().__init__(f"{service}: HTTP {status}: {body[:200]!r}")
        self.status = status


def _check(service: str, status: int, body: bytes) -> dict:
    if not 200 <= status < 300:
        raise CloudError(service, status, body)
    return json.loads(body or b"{}")


class GeminiLLM:
    """Gemini ``generateContent`` with per-session chat history.

    Mirrors ``wss/func/model.js``: a system prompt seeds every session (the
    DSL-teaching ``PAYLOAD``), history accumulates per session id, vision
    sends ``inline_data`` image parts (``session.js:114-124``).
    """

    def __init__(
        self,
        http: HttpFn,
        api_key: str,
        *,
        model: str = "gemini-1.5-flash",
        system_prompt: str = "",
        max_history: int = 64,
    ):
        self.http = http
        self.api_key = api_key
        self.model = model
        self.system_prompt = system_prompt
        self.max_history = max_history
        self._history: dict[str, list[dict]] = {}

    @property
    def _url(self) -> str:
        return (
            "https://generativelanguage.googleapis.com/v1beta/models/"
            f"{self.model}:generateContent?key={self.api_key}"
        )

    async def _call(self, contents: list[dict]) -> str:
        payload: dict = {"contents": contents}
        if self.system_prompt:
            payload["systemInstruction"] = {
                "parts": [{"text": self.system_prompt}]
            }
        status, body = await self.http("POST", self._url, json=payload)
        data = _check("gemini", status, body)
        try:
            return data["candidates"][0]["content"]["parts"][0]["text"]
        except (KeyError, IndexError) as e:
            raise CloudError("gemini", status, body) from e

    async def chat(self, session_id: str, prompt: str) -> str:
        hist = self._history.setdefault(session_id, [])
        turn = {"role": "user", "parts": [{"text": prompt}]}
        # the request carries a snapshot; history is committed only after a
        # successful reply so failed/retried calls don't leave orphan user
        # turns that diverge from what the model actually saw
        text = await self._call(hist + [turn])
        hist.append(turn)
        hist.append({"role": "model", "parts": [{"text": text}]})
        del hist[: -self.max_history]
        return text

    async def generate(self, prompt: str) -> str:
        return await self._call([{"role": "user", "parts": [{"text": prompt}]}])

    async def describe_image(self, image: bytes, prompt: str) -> str:
        return await self._call(
            [
                {
                    "role": "user",
                    "parts": [
                        {
                            "inline_data": {
                                "mime_type": "image/jpeg",
                                "data": base64.b64encode(image).decode(),
                            }
                        },
                        {"text": prompt},
                    ],
                }
            ]
        )


class GoogleCloudTTS:
    """Cloud TTS ``text:synthesize`` → LINEAR16 PCM bytes (WAV header
    stripped, matching the reference's Int16-array parse,
    ``audio.js:49-66``)."""

    def __init__(
        self,
        http: HttpFn,
        api_key: str,
        *,
        voice: str = "en-US-Journey-O",
        language: str = "en-US",
        sample_rate: int = 24000,
    ):
        self.http = http
        self.api_key = api_key
        self.voice = voice
        self.language = language
        self.sample_rate = sample_rate

    async def synthesize(self, text: str, user: str = "") -> bytes:
        status, body = await self.http(
            "POST",
            "https://texttospeech.googleapis.com/v1/text:synthesize"
            f"?key={self.api_key}",
            json={
                "input": {"text": text},
                "voice": {
                    "languageCode": self.language, "name": self.voice,
                },
                "audioConfig": {
                    "audioEncoding": "LINEAR16",
                    "sampleRateHertz": self.sample_rate,
                },
            },
        )
        data = _check("tts", status, body)
        wav = base64.b64decode(data["audioContent"])
        # LINEAR16 responses are WAV; PCM starts after the 44-byte header
        return wav[44:] if wav[:4] == b"RIFF" else wav


class GoogleCloudSTT:
    """Cloud Speech ``speech:recognize`` on LINEAR16 audio."""

    def __init__(
        self, http: HttpFn, api_key: str, *, language: str = "en-US",
        sample_rate: int = 16000,
    ):
        self.http = http
        self.api_key = api_key
        self.language = language
        self.sample_rate = sample_rate

    async def transcribe(self, audio: bytes) -> str:
        status, body = await self.http(
            "POST",
            f"https://speech.googleapis.com/v1/speech:recognize?key={self.api_key}",
            json={
                "config": {
                    "encoding": "LINEAR16",
                    "sampleRateHertz": self.sample_rate,
                    "languageCode": self.language,
                },
                "audio": {"content": base64.b64encode(audio).decode()},
            },
        )
        data = _check("stt", status, body)
        results = data.get("results") or []
        return " ".join(
            r["alternatives"][0]["transcript"]
            for r in results
            if r.get("alternatives")
        )


class GoogleMaps:
    """Places findplacefromtext + Directions, HTML-stripped step
    instructions (``google_maps.js:18-93``)."""

    def __init__(self, http: HttpFn, api_key: str):
        self.http = http
        self.api_key = api_key

    async def find_place(self, query: str, near: str | None = None) -> dict:
        from urllib.parse import quote

        q = f"{query} near {near}" if near else query
        status, body = await self.http(
            "GET",
            "https://maps.googleapis.com/maps/api/place/findplacefromtext/json"
            f"?input={quote(q)}&inputtype=textquery"
            "&fields=name,formatted_address,geometry"
            f"&key={self.api_key}",
        )
        data = _check("maps", status, body)
        cands = data.get("candidates") or []
        if not cands:
            return {}
        c = cands[0]
        return {
            "name": c.get("name", ""),
            "address": c.get("formatted_address", ""),
            "location": c.get("geometry", {}).get("location", {}),
        }

    async def directions(self, origin: str, destination: str) -> list[str]:
        from urllib.parse import quote

        status, body = await self.http(
            "GET",
            "https://maps.googleapis.com/maps/api/directions/json"
            f"?origin={quote(origin)}&destination={quote(destination)}"
            f"&key={self.api_key}",
        )
        data = _check("maps", status, body)
        routes = data.get("routes") or []
        if not routes:
            return []
        legs = routes[0].get("legs") or []
        steps = (legs[0].get("steps") or []) if legs else []
        return [_strip_html(s.get("html_instructions", "")) for s in steps]


def _strip_html(s: str) -> str:
    out, in_tag = [], False
    for ch in s:
        if ch == "<":
            in_tag = True
        elif ch == ">":
            in_tag = False
        elif not in_tag:
            out.append(ch)
    return "".join(out).strip()
