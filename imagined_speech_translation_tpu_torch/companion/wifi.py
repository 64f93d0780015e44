"""Device WiFi liveness check.

Mirrors ``app/lib/helper/wifi.dart``: the glasses push their LAN IP over BLE
(persisted under the ``ip`` pref); liveness is a plain HTTP GET to that IP
with a 5 s timeout — HTTP 200 means online, anything else (no IP stored,
socket error, timeout, non-200) means offline.

A copy of ``imagined_speech_translation_tpu.companion.wifi`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from .prefs import Preferences

TIMEOUT_SECONDS = 5.0  # wifi.dart:21


async def _default_get(url: str, timeout: float) -> int:
    """Status of a GET via urllib in a worker thread (no extra deps)."""
    import urllib.error
    import urllib.request

    def fetch() -> int:
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    return await asyncio.to_thread(fetch)


async def is_online(
    prefs: Preferences,
    *,
    http_get: Callable[[str, float], Awaitable[int]] | None = None,
    timeout: float = TIMEOUT_SECONDS,
) -> bool:
    ip = prefs.get_string("ip")
    if not ip:
        return False
    get = http_get if http_get is not None else _default_get
    try:
        status = await asyncio.wait_for(
            get(f"http://{ip}", timeout), timeout=timeout
        )
    except Exception:
        return False
    return status == 200
