"""Rendered companion device page — the GUI twin of ``app/lib/pages``.

The reference ships a Flutter device page (``app/lib/pages/device.dart``):
connection banner, battery/volume/WiFi/BLE indicators, the signed-in email,
Cast/Connect actions, a Blind Support toggle, the glasses settings screen
(``settings.dart``: WiFi credentials form, model line, sign-out) and a
recordings browser over the Drive media folder (``device.dart:106-122``).
This module renders the same surfaces as a local single-page web app served
by the stdlib HTTP server, backed by the REAL companion logic:

* state/prefs        → :class:`..companion.Preferences`
* recordings browser → :class:`..companion.RecordingsBrowser` over a Drive
  client (filesystem twin by default; the ``GoogleDrive`` adapter slots in
  when egress exists)
* WiFi provisioning  → ``wifi_qr_payload`` rendered as a real QR code
  (:mod:`.qr`, ISO 18004 byte mode / level M) for the glasses camera
* settings get/set, blind-support toggle, sign-out

Run: ``ist-companion-ui [--port 8770] [--prefs ...] [--drive-dir ...]`` and
open http://127.0.0.1:8770/ — or drive it headlessly; every surface is a
JSON endpoint under ``/api/*``.

A copy of ``imagined_speech_translation_tpu.companion.webui`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import asyncio
import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from .prefs import Preferences
from .recordings import LocalDirDrive, RecordingsBrowser
from .settings import DEVICE_MODEL
from . import qr

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Device — Imagined Speech Glasses</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 :root { color-scheme: dark; }
 body { margin:0; font:15px/1.5 system-ui,sans-serif; background:#0f1115; color:#e8eaed; }
 .wrap { max-width:430px; margin:0 auto; padding:24px 16px 96px; }
 h1 { font-size:22px; margin:12px 0 4px; }
 .status { font-size:15px; } .status.on { color:#4ade80; } .status.off { color:#f87171; }
 .muted { color:#9aa0a6; font-size:12px; }
 .avatar { width:96px; height:96px; border-radius:50%; background:radial-gradient(circle at 35% 35%, #3b4a6b, #151a24); margin:20px auto; display:flex; align-items:center; justify-content:center; font-size:40px; }
 .meters { display:flex; justify-content:center; gap:36px; margin:10px 0 16px; text-align:center; }
 .meters .ic { font-size:20px; display:block; }
 .email { text-align:center; margin:6px 0 14px; }
 .actions { text-align:center; margin-bottom:8px; }
 button, .btn { background:#2f6fed; color:#fff; border:0; border-radius:22px; padding:9px 22px; font-size:14px; cursor:pointer; }
 button.ghost { background:transparent; color:#8ab4f8; }
 hr { border:0; border-top:1px solid #2a2e37; margin:18px 0; }
 .tile { display:flex; gap:14px; padding:12px 4px; cursor:pointer; align-items:center; }
 .tile:hover { background:#161a22; border-radius:10px; }
 .tile .ic { width:28px; text-align:center; font-size:18px; }
 .tile .sub { color:#9aa0a6; font-size:12px; }
 section.panel { display:none; }
 section.panel.open { display:block; }
 input { background:#161a22; color:#e8eaed; border:1px solid #2a2e37; border-radius:8px; padding:8px 10px; width:100%; box-sizing:border-box; margin:4px 0; }
 table { width:100%; border-collapse:collapse; font-size:13px; }
 td, th { padding:6px 4px; border-bottom:1px solid #22262f; text-align:left; }
 td.act a { color:#8ab4f8; margin-right:10px; cursor:pointer; text-decoration:none; }
 #qrbox { background:#fff; border-radius:10px; padding:8px; display:inline-block; margin-top:10px; }
 .nav { position:fixed; bottom:0; left:0; right:0; background:#161a22; border-top:1px solid #2a2e37; display:flex; }
 .nav a { flex:1; text-align:center; padding:12px 0; color:#9aa0a6; text-decoration:none; font-size:12px; }
 .nav a.cur { color:#8ab4f8; }
 .kv { display:flex; justify-content:space-between; padding:4px 0; border-bottom:1px solid #1c2027; font-size:13px; }
</style></head><body><div class="wrap">
 <h1>Imagined Speech Glasses</h1>
 <div id="conn" class="status">…</div>
 <div id="synced" class="muted"></div>
 <div class="avatar">👓</div>
 <div class="meters">
  <div><span class="ic" id="bat_ic">🔋</span><span id="bat">–</span></div>
  <div><span class="ic" id="vol_ic">🔊</span><span id="vol">–</span></div>
  <div><span class="ic" id="wifi_ic">📶</span><span class="muted">wifi</span></div>
  <div><span class="ic" id="ble_ic">🛜</span><span class="muted">ble</span></div>
 </div>
 <div class="email muted" id="email"></div>
 <div class="actions">
  <button id="castBtn" style="display:none">Cast</button>
  <button id="connectBtn" onclick="openPanel('settings')">Connect</button>
 </div>
 <div class="actions"><span class="muted" id="connMsg"></span></div>
 <hr>
 <div class="tile" onclick="toggleBlind()"><div class="ic">🦯</div><div>
   <div>Blind Support</div><div class="sub" id="blindSub">…</div></div></div>
 <div class="tile" onclick="openPanel('settings')"><div class="ic">⚙️</div><div>
   <div>Glasses settings</div><div class="sub">Get info and configure your device</div></div></div>
 <div class="tile" onclick="openPanel('recordings')"><div class="ic">🎞️</div><div>
   <div>Recordings</div><div class="sub">Media folder on your Drive</div></div></div>

 <section class="panel" id="settings">
  <hr><h3>Glasses Settings</h3>
  <div class="kv"><span>Model</span><span id="model"></span></div>
  <div class="kv"><span>Signed in</span><span id="s_email"></span></div>
  <h4>Connect to WiFi</h4>
  <input id="ssid" placeholder="SSID">
  <input id="pass" placeholder="Password" type="password">
  <div style="margin-top:6px"><button onclick="wifi()">Connect</button>
   <span class="muted" id="wifiMsg"></span></div>
  <div id="qrbox" style="display:none"></div>
  <h4>All settings</h4>
  <div id="allSettings"></div>
  <div style="margin-top:8px">
   <input id="setKey" placeholder="key" style="width:45%">
   <input id="setVal" placeholder="value" style="width:45%">
   <button class="ghost" onclick="setPref()">set</button></div>
  <div style="margin-top:10px"><button class="ghost" onclick="signOut()">Sign out</button></div>
 </section>

 <section class="panel" id="recordings">
  <hr><h3>Recordings</h3>
  <div class="muted" id="recUrl"></div>
  <table id="recTable"><tr><th>name</th><th>size</th><th></th></tr></table>
 </section>

 <div class="nav">
  <a href="#" class="cur" onclick="openPanel(null)">Device</a>
  <a href="#" onclick="openPanel('recordings')">Recordings</a>
  <a href="#" onclick="openPanel('settings')">Settings</a>
 </div>
</div>
<script>
async function j(url, opts) { const r = await fetch(url, opts); return r.json(); }
function openPanel(name) {
  for (const p of document.querySelectorAll('section.panel')) p.classList.remove('open');
  if (name) { document.getElementById(name).classList.add('open');
    if (name === 'recordings') loadRecordings();
    if (name === 'settings') loadSettings(); }
}
async function refresh() {
  const s = await j('/api/state');
  const on = s.ble || s.wifi;
  const conn = document.getElementById('conn');
  conn.textContent = on ? 'Connected' : 'Not Connected';
  conn.className = 'status ' + (on ? 'on' : 'off');
  document.getElementById('synced').textContent = on ? ('Synced ' + s.synced + ' ago') : '';
  document.getElementById('bat').textContent = s.battery + '%';
  document.getElementById('vol').textContent = s.volume + '%';
  document.getElementById('wifi_ic').textContent = s.wifi ? '📶' : '📵';
  document.getElementById('ble_ic').textContent = s.ble ? '🛜' : '⛔';
  document.getElementById('email').textContent = s.email || '(not signed in)';
  document.getElementById('blindSub').textContent =
    'Blind support is currently ' + (s.blind_support ? 'enabled' : 'disabled');
  document.getElementById('castBtn').style.display = s.wifi ? '' : 'none';
  document.getElementById('connMsg').textContent = on
    ? 'Imagined Speech Glasses successfully connected'
    : 'Connect via Bluetooth for WiFi credentials';
  if (s.cast_url) document.getElementById('castBtn').onclick = () => window.open(s.cast_url);
}
async function toggleBlind() { await j('/api/blind', {method:'POST'}); refresh(); }
async function loadSettings() {
  const s = await j('/api/settings');
  document.getElementById('model').textContent = s.device.model;
  document.getElementById('s_email').textContent = s.settings.email || '—';
  document.getElementById('allSettings').innerHTML = Object.entries(s.settings)
    .map(([k, v]) => `<div class="kv"><span>${k}</span><span>${JSON.stringify(v)}</span></div>`).join('');
}
async function setPref() {
  const key = document.getElementById('setKey').value;
  const value = document.getElementById('setVal').value;
  if (!key) return;
  await j('/api/settings', {method:'POST', body: JSON.stringify({key, value})});
  loadSettings();
}
async function wifi() {
  const ssid = document.getElementById('ssid').value;
  const password = document.getElementById('pass').value;
  const r = await j('/api/wifi', {method:'POST', body: JSON.stringify({ssid, password})});
  document.getElementById('wifiMsg').textContent = r.pushed
    ? 'Connecting to WiFi…' : 'No BLE link — scan this QR with the glasses';
  const box = document.getElementById('qrbox');
  box.style.display = '';
  box.innerHTML = r.qr_svg;
}
async function signOut() { await j('/api/signout', {method:'POST'}); refresh(); }
async function loadRecordings() {
  const r = await j('/api/recordings');
  document.getElementById('recUrl').textContent = r.url;
  const rows = r.recordings.map(f =>
    `<tr><td>${f.name}</td><td>${f.size ?? ''}</td><td class="act">` +
    `<a href="/api/recordings/download?id=${encodeURIComponent(f.id)}">download</a>` +
    `<a onclick="delRec(decodeURIComponent('${encodeURIComponent(f.id)}'))">delete</a></td></tr>`).join('');
  document.getElementById('recTable').innerHTML = '<tr><th>name</th><th>size</th><th></th></tr>' + rows;
}
async function delRec(id) {
  await j('/api/recordings/delete', {method:'POST', body: JSON.stringify({id})});
  loadRecordings();
}
refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


class DeviceUI:
    """State + operations behind the rendered device page.

    ``device_write`` (optional) is the BLE write channel — when a real
    :class:`..companion.BleLink` is paired, its ``write_data`` slots in and
    the WiFi form pushes ``wifi|<key>|<ssid>|<password>`` exactly like
    ``settings.dart:177``; without it the page falls back to the
    provisioning QR for the glasses camera.
    """

    def __init__(
        self,
        prefs: Preferences,
        drive_root: str | Path,
        *,
        device_write=None,
        auth_key: str = "",
        model: str = DEVICE_MODEL,
    ):
        self.prefs = prefs
        self.browser = RecordingsBrowser(LocalDirDrive(drive_root))
        self.device_write = device_write
        self.auth_key = auth_key
        self.model = model
        self.battery = 0
        self.volume = 0
        self.ble = False
        self.connected_since: float | None = None
        self._lock = threading.Lock()

    # -- device.dart state ------------------------------------------------
    def state(self) -> dict:
        ip = self.prefs.get_string("ip")
        synced_s = (
            time.time() - self.connected_since if self.connected_since else 0
        )
        mins = int(synced_s // 60)
        synced = (
            f"{mins // 1440}d" if mins >= 1440
            else f"{mins // 60}h" if mins >= 60 else f"{mins}m"
        )
        return {
            "ble": self.ble,
            "wifi": bool(ip),
            "battery": self.battery,
            "volume": self.volume,
            "email": self.prefs.get_string("email"),
            "blind_support": self.prefs.get_bool("blind_support"),
            "synced": synced,
            "cast_url": f"https://{ip}:81/" if ip else None,  # device.dart:131
        }

    def toggle_blind(self) -> bool:
        cur = self.prefs.get_bool("blind_support")
        self.prefs.set("blind_support", not cur)
        if self.device_write is not None:
            # device.dart:376: write 'blind|<key>|<old state>'
            self._run(self.device_write(f"blind|{self.auth_key}|{cur}"))
        return not cur

    def wifi(self, ssid: str, password: str) -> dict:
        from ..runtime.personalization import wifi_qr_payload

        payload = wifi_qr_payload(ssid, password)
        pushed = False
        if self.device_write is not None:
            self._run(
                self.device_write(f"wifi|{self.auth_key}|{ssid}|{password}")
            )
            pushed = True
        return {
            "pushed": pushed,
            "payload": payload,
            "qr_svg": qr.to_svg(qr.encode(payload), module_px=5),
        }

    def sign_out(self) -> None:
        self.prefs.remove("logged")  # settings.dart:162-169
        self.prefs.remove("access_key")

    def _run(self, coro):
        return asyncio.run(coro)

    # -- HTTP plumbing ------------------------------------------------------
    def handle(self, method: str, path: str, query: dict, body: dict):
        """Route one request → (status, content_type, payload_bytes)."""

        def ok(obj) -> tuple[int, str, bytes]:
            return 200, "application/json", json.dumps(obj).encode()

        with self._lock:
            if method == "GET" and path == "/":
                return 200, "text/html; charset=utf-8", _PAGE.encode()
            if method == "GET" and path == "/api/state":
                return ok(self.state())
            if method == "POST" and path == "/api/blind":
                return ok({"blind_support": self.toggle_blind()})
            if method == "GET" and path == "/api/settings":
                return ok(
                    {
                        "settings": self.prefs.snapshot(),
                        "device": {"model": self.model},
                    }
                )
            if method == "POST" and path == "/api/settings":
                self.prefs.set(str(body["key"]), body.get("value"))
                return ok({"settings": self.prefs.snapshot()})
            if method == "POST" and path == "/api/wifi":
                return ok(self.wifi(body.get("ssid", ""), body.get("password", "")))
            if method == "POST" and path == "/api/signout":
                self.sign_out()
                return ok({"signed_in": False})
            if method == "GET" and path == "/api/qr":
                text = (query.get("text") or [""])[0]
                svg = qr.to_svg(qr.encode(text))
                return 200, "image/svg+xml", svg.encode()
            if method == "GET" and path == "/api/recordings":
                recs = self._run(self.browser.list_recordings())
                url = self._run(self.browser.folder_url())
                return ok({"recordings": recs, "url": url})
            if method == "POST" and path == "/api/recordings/save":
                content = base64.b64decode(body.get("content_b64", ""))
                meta = self._run(
                    self.browser.save_recording(str(body["name"]), content)
                )
                return ok({"saved": meta})
            if method == "GET" and path == "/api/recordings/download":
                file_id = (query.get("id") or [""])[0]
                if ".." in file_id or file_id.startswith("/"):
                    return 400, "application/json", b'{"error": "bad id"}'
                data = self._run(self.browser.drive.download(file_id))
                return 200, "application/octet-stream", data
            if method == "POST" and path == "/api/recordings/delete":
                self._run(self.browser.delete(str(body["id"])))
                return ok({"deleted": body["id"]})
        return 404, "application/json", b'{"error": "not found"}'


def serve(ui: DeviceUI, host: str = "127.0.0.1", port: int = 8770):
    """Blocking server; returns the ``ThreadingHTTPServer`` when used via
    ``start()`` below (tests run it on a thread)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _dispatch(self, method: str) -> None:
            u = urlparse(self.path)
            body = {}
            n = int(self.headers.get("Content-Length") or 0)
            if n:
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    body = {}
            try:
                status, ctype, payload = ui.handle(
                    method, u.path, parse_qs(u.query), body
                )
            except (KeyError, FileNotFoundError) as e:
                status, ctype, payload = (
                    400,
                    "application/json",
                    json.dumps({"error": repr(e)}).encode(),
                )
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8770)
    ap.add_argument("--prefs", default=str(Path.home() / ".ist_companion.json"))
    ap.add_argument(
        "--drive-dir", default=str(Path.home() / ".ist_recordings"),
        help="filesystem Drive twin for the recordings browser",
    )
    args = ap.parse_args(argv)
    ui = DeviceUI(Preferences(args.prefs), args.drive_dir)
    srv = serve(ui, args.host, args.port)
    print(f"device page on http://{args.host}:{args.port}/", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
