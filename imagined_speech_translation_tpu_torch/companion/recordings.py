"""Recordings browser over the Drive-shaped storage plane.

The reference device page keeps the glasses' media in the user's Google
Drive: find-or-create a ``Gemini Sight Media`` folder and open its URL
(``app/lib/pages/device.dart:87-117``).  The Flutter page stops at
launching the folder in a browser; this headless equivalent completes the
logic surface — list, download, delete, and (for the device side) save
recordings — against a pluggable Drive client:

* :class:`GoogleDrive` — the real Drive v3 wire format over an injected
  async ``http`` callable (same adapter pattern as
  :mod:`..runtime.adapters`; wire shapes pinned by offline tests);
* :class:`InMemoryDrive` — test fake honoring the app's exact query
  strings;
* :class:`LocalDirDrive` — filesystem-backed twin for headless/offline use
  (``ist-companion --drive-dir``), one file per recording plus a metadata
  sidecar.

A copy of ``imagined_speech_translation_tpu.companion.recordings`` (it
imports no jax), so the port imports nothing of the JAX package; a test
holds its code to the original's.
"""

from __future__ import annotations

import json
import re
import time
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Awaitable, Callable, Protocol

MEDIA_FOLDER = "Gemini Sight Media"  # device.dart:113
FOLDER_MIME = "application/vnd.google-apps.folder"

# device.dart:89-91 — the exact find query the app issues
FOLDER_QUERY = (
    "mimeType='application/vnd.google-apps.folder' and "
    "name='{name}' and trashed=false and 'root' in parents"
)
# device.dart:116-117 — the URL the app launches
FOLDER_URL = "https://drive.google.com/drive/u/2/folders/{folder_id}"


class DriveClient(Protocol):
    async def list_files(self, q: str) -> list[dict]: ...

    async def create(
        self, meta: dict, content: bytes | None = None,
        mime: str = "application/octet-stream",
    ) -> dict: ...

    async def download(self, file_id: str) -> bytes: ...

    async def delete(self, file_id: str) -> None: ...


# ---------------------------------------------------------------------------
# real wire format (Drive v3)
# ---------------------------------------------------------------------------

HttpFn = Callable[..., Awaitable[tuple[int, bytes]]]
_FIELDS = "files(id,name,mimeType,size,createdTime,parents)"


class GoogleDrive:
    """Drive v3 REST wire format (www.googleapis.com/drive/v3).

    ``http(method, url, headers=..., body=...) -> (status, bytes)`` is
    injected so tests pin the request shapes offline and production wires a
    real client; ``token`` is the user's OAuth bearer token (the app's
    ``GoogleAPIClient(await account.authHeaders)``, device.dart:111)."""

    BASE = "https://www.googleapis.com/drive/v3"
    UPLOAD = "https://www.googleapis.com/upload/drive/v3"

    def __init__(self, http: HttpFn, token: str):
        self._http = http
        self._auth = {"Authorization": f"Bearer {token}"}

    async def list_files(self, q: str) -> list[dict]:
        url = (
            f"{self.BASE}/files?q={urllib.parse.quote(q)}"
            f"&fields={urllib.parse.quote(_FIELDS)}&spaces=drive"
        )
        status, body = await self._http("GET", url, headers=self._auth)
        _check(status, body)
        return json.loads(body).get("files", [])

    async def create(
        self, meta: dict, content: bytes | None = None,
        mime: str = "application/octet-stream",
    ) -> dict:
        if content is None:
            status, body = await self._http(
                "POST", f"{self.BASE}/files",
                headers={**self._auth, "Content-Type": "application/json"},
                body=json.dumps(meta).encode(),
            )
        else:
            boundary = "ist-upload-boundary"
            payload = (
                f"--{boundary}\r\n"
                "Content-Type: application/json; charset=UTF-8\r\n\r\n"
                f"{json.dumps(meta)}\r\n"
                f"--{boundary}\r\nContent-Type: {mime}\r\n\r\n"
            ).encode() + content + f"\r\n--{boundary}--".encode()
            status, body = await self._http(
                "POST", f"{self.UPLOAD}/files?uploadType=multipart",
                headers={
                    **self._auth,
                    "Content-Type": f"multipart/related; boundary={boundary}",
                },
                body=payload,
            )
        _check(status, body)
        return json.loads(body)

    async def download(self, file_id: str) -> bytes:
        status, body = await self._http(
            "GET", f"{self.BASE}/files/{file_id}?alt=media",
            headers=self._auth,
        )
        _check(status, body)
        return body

    async def delete(self, file_id: str) -> None:
        status, body = await self._http(
            "DELETE", f"{self.BASE}/files/{file_id}", headers=self._auth
        )
        if status not in (200, 204):
            _check(status, body)


def _check(status: int, body: bytes) -> None:
    if status != 200:
        raise RuntimeError(f"drive: HTTP {status}: {body[:200]!r}")


# ---------------------------------------------------------------------------
# fakes / offline twins
# ---------------------------------------------------------------------------

_Q_NAME = re.compile(r"name='([^']*)'")
_Q_MIME = re.compile(r"mimeType='([^']*)'")
_Q_PARENT = re.compile(r"'([^']*)' in parents")


def _match(q: str, f: dict) -> bool:
    """Match the app's query shapes (device.dart:89, query.dart:37)."""
    m = _Q_MIME.search(q)
    if m and f.get("mimeType") != m.group(1):
        return False
    m = _Q_NAME.search(q)
    if m and f.get("name") != m.group(1):
        return False
    if "trashed=false" in q and f.get("trashed"):
        return False
    m = _Q_PARENT.search(q)
    if m and m.group(1) not in f.get("parents", ["root"]):
        return False
    return True


@dataclass
class InMemoryDrive:
    files: dict[str, dict] = field(default_factory=dict)
    blobs: dict[str, bytes] = field(default_factory=dict)
    _next: int = 1

    async def list_files(self, q: str) -> list[dict]:
        return [dict(f) for f in self.files.values() if _match(q, f)]

    async def create(self, meta, content=None, mime="application/octet-stream"):
        fid = f"file{self._next}"
        self._next += 1
        f = {
            "id": fid,
            "name": meta.get("name", fid),
            "mimeType": meta.get("mimeType", mime),
            "parents": meta.get("parents", ["root"]),
            "createdTime": meta.get("createdTime")
            or time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "size": str(len(content or b"")),
        }
        self.files[fid] = f
        if content is not None:
            self.blobs[fid] = content
        return dict(f)

    async def download(self, file_id: str) -> bytes:
        if file_id not in self.blobs:
            raise RuntimeError(f"drive: no content for {file_id}")
        return self.blobs[file_id]

    async def delete(self, file_id: str) -> None:
        self.files.pop(file_id, None)
        self.blobs.pop(file_id, None)


class LocalDirDrive:
    """Filesystem Drive twin: ``root/<folder>/<name>`` + ``_meta.json``.

    Lets the headless CLI operate a persistent recordings store with no
    network; ids are ``<folder>/<name>`` relative paths."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._meta_path = self.root / "_meta.json"
        self._meta = (
            json.loads(self._meta_path.read_text())
            if self._meta_path.exists()
            else {}
        )

    def _save_meta(self) -> None:
        self._meta_path.write_text(json.dumps(self._meta, indent=1))

    async def list_files(self, q: str) -> list[dict]:
        return [dict(f) for f in self._meta.values() if _match(q, f)]

    async def create(self, meta, content=None, mime="application/octet-stream"):
        name = meta.get("name", "unnamed")
        parents = meta.get("parents", ["root"])
        is_folder = meta.get("mimeType") == FOLDER_MIME
        fid = name if is_folder else f"{parents[0]}/{name}"
        f = {
            "id": fid, "name": name,
            "mimeType": meta.get("mimeType", mime), "parents": parents,
            "createdTime": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "size": str(len(content or b"")),
        }
        self._meta[fid] = f
        if is_folder:
            (self.root / name).mkdir(exist_ok=True)
        elif content is not None:
            path = self.root / fid
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(content)
        self._save_meta()
        return dict(f)

    async def download(self, file_id: str) -> bytes:
        return (self.root / file_id).read_bytes()

    async def delete(self, file_id: str) -> None:
        self._meta.pop(file_id, None)
        p = self.root / file_id
        if p.is_file():
            p.unlink()
        self._save_meta()


# ---------------------------------------------------------------------------
# the browser
# ---------------------------------------------------------------------------


class RecordingsBrowser:
    """The device page's media surface, headless: find-or-create the media
    folder (device.dart:104-117) plus the list/download/delete operations
    the rendered folder view provides."""

    def __init__(self, drive: DriveClient, folder_name: str = MEDIA_FOLDER):
        self.drive = drive
        self.folder_name = folder_name
        self._folder: dict | None = None

    async def ensure_media_folder(self) -> dict:
        """device.dart:112-115 — find, else create."""
        if self._folder is None:
            found = await self.drive.list_files(
                FOLDER_QUERY.format(name=self.folder_name)
            )
            self._folder = found[0] if found else await self.drive.create(
                {"name": self.folder_name, "mimeType": FOLDER_MIME}
            )
        return self._folder

    async def folder_url(self) -> str:
        folder = await self.ensure_media_folder()
        return FOLDER_URL.format(folder_id=folder["id"])

    async def list_recordings(self) -> list[dict]:
        folder = await self.ensure_media_folder()
        files = await self.drive.list_files(
            f"trashed=false and '{folder['id']}' in parents"
        )
        return sorted(
            files, key=lambda f: f.get("createdTime", ""), reverse=True
        )

    async def save_recording(
        self, name: str, content: bytes, mime: str = "video/avi"
    ) -> dict:
        """Device-side leg: the assembled capture (``runtime/media.py``)
        lands in the same folder the app browses."""
        folder = await self.ensure_media_folder()
        return await self.drive.create(
            {"name": name, "parents": [folder["id"]]}, content, mime
        )

    async def download_to(self, file_id: str, dest: str | Path) -> Path:
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(await self.drive.download(file_id))
        return dest

    async def delete(self, file_id: str) -> None:
        await self.drive.delete(file_id)
