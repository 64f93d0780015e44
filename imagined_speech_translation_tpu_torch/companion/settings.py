"""Device settings panel — headless twin of ``DeviceSettings``.

The reference settings page (``app/lib/pages/settings.dart:22-182``)
surfaces: the signed-in user's name/email/avatar, a WiFi-credentials form
that pushes ``wifi|<key>|<ssid>|<password>`` to the glasses over BLE
(:177), the device model line, and sign-out (clears the ``logged`` pref,
:162-169).  This module provides the same operations plus generic
settings get/set over the persisted preference store (the page's
``SharedPreferences`` counterpart).

A copy of ``imagined_speech_translation_tpu.companion.settings`` (it imports
no jax), so the port imports nothing of the JAX package; a test holds its
code to the original's.
"""

from __future__ import annotations

from dataclasses import dataclass

from .client import CompanionClient

DEVICE_MODEL = "Gemini Sight Glasses"


@dataclass
class SettingsPanel:
    client: CompanionClient
    model: str = DEVICE_MODEL

    # -- user info block (settings.dart:72-93) ---------------------------
    async def user_info(self) -> dict:
        return {
            "display_name": await self.client.get_display_name(),
            "email": self.client.prefs.get_string("email"),
        }

    # -- WiFi form (settings.dart:171-181) --------------------------------
    async def connect_wifi(self, ssid: str, password: str) -> None:
        """Push credentials to the glasses over the BLE channel — the same
        frame the page writes: ``wifi|$authentication_key|$ssid|$password``."""
        if self.client._device_write is None:
            raise RuntimeError("no device connected (pair over BLE first)")
        await self.client._device_write(
            f"wifi|{self.client.access_key}|{ssid}|{password}"
        )

    # -- device info footer (settings.dart:135-160) -----------------------
    def device_info(self) -> dict:
        return {"model": self.model}

    # -- sign-out (settings.dart:162-169) ----------------------------------
    def sign_out(self) -> None:
        self.client.sign_out()

    # -- generic persisted settings ---------------------------------------
    def get(self, key: str, default=None):
        return self.client.prefs.get(key, default)

    def set(self, key: str, value) -> None:
        self.client.prefs.set(key, value)

    def all(self) -> dict:
        """Snapshot of the persisted store (prefs file contents)."""
        return self.client.prefs.snapshot()
