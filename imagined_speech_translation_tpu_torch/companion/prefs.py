"""Persisted client preferences.

The reference app stores flags and the device IP in Android/iOS
``shared_preferences`` (``app/lib/pages/sign_in.dart:110,185-186``,
``app/lib/helper/ble.dart:93-94``, ``app/lib/helper/wifi.dart:10-11``).
Keys actually used by the app: ``logged``, ``first_time``, ``blind_support``,
``ip``.  This is the host-side equivalent: a small JSON file with atomic
writes so a crash mid-save never corrupts the store.

A copy of ``imagined_speech_translation_tpu.companion.prefs`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any


class Preferences:
    """JSON-file-backed key/value store (shared_preferences equivalent)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self._path = Path(path) if path is not None else None
        self._data: dict[str, Any] = {}
        if self._path is not None and self._path.exists():
            try:
                self._data = json.loads(self._path.read_text())
            except (json.JSONDecodeError, OSError):
                self._data = {}

    # -- typed getters matching the shared_preferences surface -------------
    def get_string(self, key: str) -> str | None:
        v = self._data.get(key)
        return v if isinstance(v, str) else None

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._data.get(key)
        return v if isinstance(v, bool) else default

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._data.get(key)
        return v if isinstance(v, int) and not isinstance(v, bool) else default

    def set(self, key: str, value: Any) -> None:
        self._data[key] = value
        self._flush()

    def remove(self, key: str) -> None:
        self._data.pop(key, None)
        self._flush()

    def get(self, key: str, default: Any = None) -> Any:
        """Untyped read (the settings panel's generic surface)."""
        return self._data.get(key, default)

    def snapshot(self) -> dict:
        """Copy of the full store (for display/inspection)."""
        return dict(self._data)

    def _flush(self) -> None:
        if self._path is None:
            return
        self._path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(self._path.parent), prefix=self._path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f)
            os.replace(tmp, self._path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
