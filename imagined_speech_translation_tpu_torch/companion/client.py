"""Companion control-plane client: sign-in, onboarding, profile helpers.

Mirrors the app's cloud-plane state machine:

* ``sign_in`` — ``authentication¬idToken`` -> access key; an empty/denied
  key means the account "hasn't purchased the glasses" and the login is
  rolled back (``app/lib/pages/sign_in.dart:108-147``); then
  ``auth_code¬key¬serverAuthCode`` persistence (:150-162) and the
  first-login flow: ``first_time¬key¬email`` -> if true, upload the user's
  documents in batches of 50 (``helper/query.dart``), then mark
  ``not_first_time`` and persist ``logged``/``first_time`` prefs (:167-189).
* ``auto_login`` — the splash screen resumes a session iff the ``logged``
  pref is set (``splash_screen.dart:38``).
* ``sign_out`` — clears ``logged`` (``settings.dart:164``).
* token/name helpers — ``get_auth_code`` / ``get_refresh_token`` /
  ``get_display_name`` request/response (``helper/helper.dart:15-86``).
* ``set_blind_support`` — persists the toggle and notifies the device over
  the BLE channel as ``blind|key|<bool>`` (``pages/device.dart:376-385``).

Replies use this runtime's framing (``ok¬<command>¬<json>`` /
``error¬<kind>¬<msg>``, :mod:`..runtime.server`); async ``utterance`` frames
arriving between a request and its reply are buffered into :attr:`events`.

A copy of ``imagined_speech_translation_tpu.companion.client`` (it imports
no jax), so the port imports nothing of the JAX package; a test holds its
code to the original's.
"""

from __future__ import annotations

import json
from typing import Awaitable, Callable, Iterable

from ..runtime.personalization import PersonalizationCrawler
from ..runtime.protocol import TextFrame, decode_text_frame, encode_text_frame
from .prefs import Preferences
from .transport import Transport

NOT_PURCHASED_MESSAGE = (
    "Please log in with an account that has purchased the glasses."
)


class CompanionError(Exception):
    """Protocol-level failure reported by the server."""


class AuthenticationError(CompanionError):
    """Sign-in rejected (no access key for this account)."""


class CompanionClient:
    def __init__(
        self,
        transport: Transport,
        prefs: Preferences | None = None,
        *,
        device_write: Callable[[str], Awaitable[None]] | None = None,
    ):
        self.transport = transport
        self.prefs = prefs if prefs is not None else Preferences()
        self.access_key: str = ""
        #: async frames (e.g. decoded utterances) seen while awaiting replies
        self.events: list[TextFrame] = []
        # BLE write hook for device-directed toggles (wired by the host to
        # BleLink.write_data); None = no device connected
        self._device_write = device_write

    # ------------------------------------------------------------------
    async def request(self, command: str, args: Iterable[str] = ()) -> object:
        """Send ``command¬key¬args`` and return the decoded JSON result."""
        return await self._request(
            TextFrame(command, self.access_key, tuple(args))
        )

    async def _request(self, frame: TextFrame) -> object:
        await self.transport.send(encode_text_frame(frame))
        while True:
            reply = decode_text_frame(await self.transport.receive())
            if reply.command == "ok":
                return json.loads(reply.args[0]) if reply.args else None
            if reply.command == "error":
                msg = reply.args[0] if reply.args else ""
                if reply.access_key == "auth":
                    raise AuthenticationError(msg)
                raise CompanionError(msg)
            # interleaved async frame (utterance etc.) — buffer and keep
            # waiting for THIS request's reply (single-request discipline)
            self.events.append(reply)

    # ------------------------------------------------------------------
    async def sign_in(
        self,
        id_token: str,
        *,
        server_auth_code: str = "",
        email: str = "",
        documents: Iterable[str] | None = None,
    ) -> str:
        """Full sign-in flow; returns the access key.

        ``documents`` is the personalization corpus (the app pulls Gmail
        bodies + Docs text); only uploaded when the server says this is the
        account's first login.
        """
        try:
            key = await self._request(TextFrame("authentication", id_token))
        except AuthenticationError:
            # the reference signals rejection with an EMPTY key and signs
            # the Google session back out (sign_in.dart:125-132)
            self.sign_out()
            raise AuthenticationError(NOT_PURCHASED_MESSAGE) from None
        if not isinstance(key, str) or not key:
            self.sign_out()
            raise AuthenticationError(NOT_PURCHASED_MESSAGE)
        self.access_key = key

        if server_auth_code:
            await self.request("auth_code", (server_auth_code,))

        first = await self.request("first_time", (email,) if email else ())
        if isinstance(first, dict) and first.get("first_time"):
            # mark the account only once the personalization corpus has
            # actually been uploaded — signing in without documents must
            # NOT forfeit the one-shot first-login upload
            # (sign_in.dart:150-189 runs the crawl before notFirstTime)
            if documents is not None:
                await self.upload_personalization(documents)
                await self.request("not_first_time")
        self.prefs.set("logged", True)
        self.prefs.set("first_time", False)
        if email:
            self.prefs.set("email", email)  # settings page's user-info block
        return key

    async def upload_personalization(self, documents: Iterable[str]) -> int:
        """Batch-upload documents as ``add_query`` frames (query.dart)."""

        async def send(frame: TextFrame) -> object:
            return await self._request(frame)

        crawler = PersonalizationCrawler(access_key=self.access_key, send=send)
        return await crawler.upload(documents)

    # ------------------------------------------------------------------
    def auto_login(self) -> bool:
        """Splash-screen resume check (splash_screen.dart:38)."""
        return self.prefs.get_bool("logged")

    def sign_out(self) -> None:
        self.prefs.set("logged", False)
        self.access_key = ""

    # -- token / profile helpers (helper/helper.dart) --------------------
    async def get_auth_code(self) -> str | None:
        res = await self.request("get_auth_code")
        return res.get("auth_code") if isinstance(res, dict) else None

    async def get_refresh_token(self) -> str | None:
        res = await self.request("get_refresh_token")
        return res.get("refresh_token") if isinstance(res, dict) else None

    async def get_display_name(self) -> str | None:
        res = await self.request("get_display_name")
        return res.get("display_name") if isinstance(res, dict) else None

    async def set_ble_id(self, ble_id: str) -> None:
        await self.request("ble_id", (ble_id,))

    async def get_ble_id(self) -> str | None:
        res = await self.request("ble_id")
        return res.get("ble_id") if isinstance(res, dict) else None

    # -- device page -----------------------------------------------------
    async def set_blind_support(self, enabled: bool) -> None:
        """Toggle blind support: pref + device notification
        (device.dart:376-385; the device frame rides the BLE channel)."""
        self.prefs.set("blind_support", enabled)
        if self._device_write is not None:
            flag = "true" if enabled else "false"
            await self._device_write(f"blind|{self.access_key}|{flag}")
