"""Companion client — the user-surface counterpart of the runtime server.

The reference ships a Flutter app ("Tacit", ``app/lib/``, ~1,860 LoC) whose
non-UI behaviors are: Google sign-in -> access-key exchange with the cloud
plane (``app/lib/pages/sign_in.dart:83-188``), first-login personalization
upload (``app/lib/helper/query.dart``), BLE pairing with command dispatch
(``app/lib/helper/ble.dart``), phone-side contact/call/SMS relays
(``app/lib/helper/commands.dart``), WiFi liveness polling
(``app/lib/helper/wifi.dart``), token/display-name helpers
(``app/lib/helper/helper.dart``), and persisted preferences
(shared_preferences).  This package implements every one of those behaviors
as a transport-agnostic Python client so a headless host (or any future UI)
can drive the full companion protocol against
:mod:`imagined_speech_translation_tpu_torch.runtime`.  The rendered device page
(:mod:`.webui` + ``ist-companion-ui``) serves the same surfaces as a local
web app — connection banner, meters, blind-support toggle, settings +
WiFi-QR provisioning (:mod:`.qr`), recordings browser — replacing the
reference's Flutter widgets with a dependency-free HTML twin.

A copy of ``imagined_speech_translation_tpu.companion`` (it imports no jax),
so the port imports nothing of the JAX package; a test holds its code to the
original's.
"""

from .ble import BleLink, BleTransport, InMemoryBle
from .client import AuthenticationError, CompanionClient, CompanionError
from .phone import Contact, InMemoryPhone, PhoneActions
from .prefs import Preferences
from .recordings import (
    GoogleDrive,
    InMemoryDrive,
    LocalDirDrive,
    RecordingsBrowser,
)
from .settings import SettingsPanel
from .transport import InProcessTransport, WebsocketTransport
from .webui import DeviceUI
from .wifi import is_online

__all__ = [
    "AuthenticationError",
    "BleLink",
    "BleTransport",
    "CompanionClient",
    "CompanionError",
    "Contact",
    "DeviceUI",
    "GoogleDrive",
    "InMemoryBle",
    "InMemoryDrive",
    "InMemoryPhone",
    "InProcessTransport",
    "LocalDirDrive",
    "PhoneActions",
    "Preferences",
    "RecordingsBrowser",
    "SettingsPanel",
    "WebsocketTransport",
    "is_online",
]
