"""BLE pairing + device command dispatch.

Mirrors ``app/lib/helper/ble.dart``: scan for the glasses by BLE id (5 s
scan window), connect, subscribe to the notification characteristic, and
dispatch incoming ascii frames ``<command>|<auth_key>|<args...>``:

* ``ip`` — persist the device's LAN address (used by WiFi liveness)
* ``volume`` / ``battery`` — update companion-visible device state
* ``contacts`` / ``call`` / ``text`` — phone-side relays
  (:mod:`.phone`); replies ride the same characteristic

Frames whose auth key doesn't match are silently dropped (ble.dart:87), as
are malformed frames (fewer than two ``|`` parts, ble.dart:83).  On a
``disconnected`` state event the link auto-reconnects (ble.dart:46-53).

The radio itself is behind :class:`BleTransport` so any host (bleak,
dbus, a test harness) can plug in; :class:`InMemoryBle` is the loopback
implementation used by tests and the headless demo.

A copy of ``imagined_speech_translation_tpu.companion.ble`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Protocol, Sequence

from .phone import PhoneActions
from .prefs import Preferences

SCAN_SECONDS = 5.0  # ble.dart:20


class BleTransport(Protocol):
    """Platform radio adapter."""

    async def scan(self, timeout: float) -> Sequence[tuple[str, object]]:
        """Returns ``(device_id, device_handle)`` pairs seen in the window."""
        ...

    async def connect(self, device: object) -> None: ...

    def on_state(self, callback: Callable[[str], Awaitable[None]]) -> None:
        """``callback('connected'|'disconnected')`` on link state changes."""
        ...

    def on_notify(self, callback: Callable[[bytes], Awaitable[None]]) -> None: ...

    async def write(self, data: bytes) -> None: ...


@dataclass
class InMemoryBle:
    """Loopback transport: devices are dicts, writes are recorded, and the
    test drives notifications/state transitions explicitly."""

    devices: dict[str, object] = field(default_factory=dict)
    written: list[bytes] = field(default_factory=list)
    connected_to: object | None = None
    _state_cb: Callable[[str], Awaitable[None]] | None = None
    _notify_cb: Callable[[bytes], Awaitable[None]] | None = None

    async def scan(self, timeout: float) -> Sequence[tuple[str, object]]:
        return list(self.devices.items())

    async def connect(self, device: object) -> None:
        self.connected_to = device

    def on_state(self, callback) -> None:
        self._state_cb = callback

    def on_notify(self, callback) -> None:
        self._notify_cb = callback

    async def write(self, data: bytes) -> None:
        self.written.append(data)

    # -- test drivers --------------------------------------------------
    async def emit_state(self, state: str) -> None:
        if self._state_cb is not None:
            await self._state_cb(state)

    async def emit_notify(self, data: bytes) -> None:
        if self._notify_cb is not None:
            await self._notify_cb(data)


class BleLink:
    """Companion<->glasses BLE session."""

    def __init__(
        self,
        transport: BleTransport,
        *,
        ble_id: str,
        auth_key: str,
        prefs: Preferences,
        phone: PhoneActions | None = None,
    ):
        self.transport = transport
        self.ble_id = ble_id
        self.auth_key = auth_key
        self.prefs = prefs
        self.phone = phone
        self.connected = False
        self.volume = 0
        self.battery = 0
        self._device: object | None = None
        transport.on_state(self._on_state)
        transport.on_notify(self.read_data)

    # ------------------------------------------------------------------
    async def scan_devices(self, timeout: float = SCAN_SECONDS) -> bool:
        """Scan and connect to the device whose id matches ``ble_id``;
        True only if the connection actually came up (a found-but-failed
        connect must count as a miss so ``pair`` keeps retrying)."""
        for device_id, device in await self.transport.scan(timeout):
            if device_id == self.ble_id:
                await self.connect_device(device)
                return self.connected
        return False

    async def connect_device(self, device: object) -> None:
        try:
            await self.transport.connect(device)
        except Exception:
            self.connected = False  # ble.dart:70-72
            return
        self._device = device
        self.connected = True

    async def _on_state(self, state: str) -> None:
        if state == "disconnected":
            self.connected = False
            if self._device is not None:  # auto-reconnect, ble.dart:46-53
                await self.connect_device(self._device)
        elif state == "connected":
            self.connected = True

    # ------------------------------------------------------------------
    async def read_data(self, data: bytes) -> None:
        """Dispatch one notification frame (ble.dart:79-115)."""
        try:
            parts = data.decode("ascii").split("|")
        except UnicodeDecodeError:
            return
        if len(parts) < 2 or parts[1] != self.auth_key:
            return
        command, args = parts[0], parts[2:]
        if command == "ip" and len(args) == 1:
            self.prefs.set("ip", args[0])
        elif command == "volume" and args:
            self.volume = _int_or(args[0], self.volume)
        elif command == "battery" and args:
            self.battery = _int_or(args[0], self.battery)
        elif command == "contacts" and len(args) == 1 and self.phone:
            await self.phone.contacts(args[0])
        elif command == "call" and len(args) == 1 and self.phone:
            await self.phone.call(args[0])
        elif command == "text" and len(args) == 2 and self.phone:
            await self.phone.text(args[0], args[1])

    async def write_data(self, data: str) -> None:
        """Write to the device characteristic (ble.dart:121-127)."""
        await self.transport.write(data.encode("ascii"))


def _int_or(s: str, default: int) -> int:
    try:
        return int(s)
    except ValueError:
        return default


async def pair(
    transport: BleTransport,
    *,
    ble_id: str,
    auth_key: str,
    prefs: Preferences,
    phone: PhoneActions | None = None,
    retries: int = 3,
    scan_seconds: float = SCAN_SECONDS,
) -> BleLink | None:
    """Scan-with-retry convenience: returns a connected link or None."""
    link = BleLink(
        transport, ble_id=ble_id, auth_key=auth_key, prefs=prefs, phone=phone
    )
    for _ in range(max(retries, 1)):
        if await link.scan_devices(scan_seconds):
            return link
        await asyncio.sleep(0)
    return None
