"""Drive the rendered companion device page end-to-end over real HTTP.

Port of ``examples/device_page_demo.py``.  Starts the port's device-page
server (``companion.webui``) in-process on an ephemeral port, then walks the
reference app's device-page journey: read state -> the glasses push their
LAN ip (wifi goes live, Cast appears) -> toggle Blind Support -> settings
panel -> WiFi provisioning (renders the QR the glasses camera scans) ->
recordings browser (save / list / download / delete).

Writes ``device_page_transcript.json`` and the rendered
``wifi_provision_qr.svg`` into ``--out`` (default
``build/device_page_demo``), with the page's state under
``<out>/_device_demo_state``; the transcript's ``qr_svg`` entry names the
SVG written.  Runs no model, so it takes no ``--device``.

    python -m imagined_speech_translation_tpu_torch.examples.device_page_demo [--out DIR]
"""

from __future__ import annotations

import argparse
import base64
import json
import shutil
import threading
import urllib.request
from pathlib import Path
from urllib.parse import quote

from ..companion import DeviceUI, Preferences
from ..companion.webui import serve

REPO = Path(__file__).resolve().parents[2]


def get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def post(url, obj=None):
    req = urllib.request.Request(url, data=json.dumps(obj or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def run(out: Path) -> list:
    """The journey; returns the transcript (also written to ``out``)."""
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / "_device_demo_state"
    shutil.rmtree(tmp, ignore_errors=True)  # each run starts from a fresh page
    tmp.mkdir()
    prefs = Preferences(tmp / "prefs.json")
    prefs.set("email", "user@example.com")
    ui = DeviceUI(prefs, tmp / "drive")
    srv = serve(ui, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    t: list = []
    try:
        page = get(base + "/").decode()
        t.append(["GET /", f"{len(page)} bytes of device page HTML"])

        t.append(["GET /api/state (fresh)", json.loads(get(base + "/api/state"))])
        prefs.set("ip", "192.168.4.21")  # the glasses push their LAN ip over BLE
        t.append(["glasses push ip over BLE", "prefs['ip'] = 192.168.4.21"])
        t.append(["GET /api/state (online)", json.loads(get(base + "/api/state"))])

        t.append(["POST /api/blind", post(base + "/api/blind")])
        t.append(["GET /api/settings", json.loads(get(base + "/api/settings"))])

        wifi = post(base + "/api/wifi", {"ssid": "glasses-net", "password": "secret123"})
        svg = out / "wifi_provision_qr.svg"
        svg.write_text(wifi.pop("qr_svg"))
        wifi["qr_svg"] = f"-> {svg}"
        t.append(["POST /api/wifi", wifi])

        saved = post(
            base + "/api/recordings/save",
            {"name": "morning-walk.avi",
             "content_b64": base64.b64encode(b"demo recording bytes").decode()},
        )["saved"]
        t.append(["POST /api/recordings/save", saved])
        t.append(["GET /api/recordings", json.loads(get(base + "/api/recordings"))])
        body = get(base + "/api/recordings/download?id=" + quote(saved["id"]))
        t.append(["GET /api/recordings/download", f"{len(body)} bytes"])
        t.append(["POST /api/recordings/delete",
                  post(base + "/api/recordings/delete", {"id": saved["id"]})])
        t.append(["POST /api/signout", post(base + "/api/signout")])
    finally:
        srv.shutdown()
        srv.server_close()
    (out / "device_page_transcript.json").write_text(json.dumps(t, indent=1, ensure_ascii=False))
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "build" / "device_page_demo"))
    args = ap.parse_args(argv)
    out = Path(args.out)
    t = run(out)
    print(json.dumps(t, indent=1, ensure_ascii=False))
    print(f"\ntranscript -> {out / 'device_page_transcript.json'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
