"""The port's companion client, its web UI and CLI, and the runtime adapters,
media and reminders, against the JAX package's jax-free originals.

Each scenario is one function of a namespace (``JAX`` or ``PORT``: the
``companion`` package and its modules, ``cli.companion`` and the runtime
modules of either package) and a scratch directory; it drives the classes as
``tests/test_companion.py``, ``tests/test_companion_ui.py`` (the device page
over real HTTP on an ephemeral port), ``tests/test_runtime_adapters.py``
(a fake HTTP transport replaying the documented API shapes) and
``tests/test_runtime_loop.py`` do, keeps their assertions, and returns what
it observed as plain data (random access keys, wall-clock times and scratch
paths left out).  Each test case runs one scenario through both packages and
requires equal results.  ``cli.companion``'s offline surfaces
(``--settings``, ``--settings-set``, ``--wifi``, the recordings browser over
``--drive-dir``, the usage errors and ``--help``) must print the same output
through both packages.  Each copied module's code (docstrings aside) must be
the original's.
"""

import asyncio
import base64
import contextlib
import importlib
import io
import json
import struct
import threading
import urllib.parse
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_runtime import _code, outcome

COMPANION = ("prefs", "transport", "client", "settings", "phone", "ble", "wifi", "qr",
             "recordings", "webui")
RUNTIME = ("adapters", "auth", "commands", "media", "protocol", "reminders", "server",
           "services", "session")


def _namespace(pkg):
    ns = SimpleNamespace(**{m: importlib.import_module(f"{pkg}.companion.{m}") for m in COMPANION})
    ns.c = importlib.import_module(f"{pkg}.companion")
    ns.rt = SimpleNamespace(**{m: importlib.import_module(f"{pkg}.runtime.{m}") for m in RUNTIME})
    ns.cli = importlib.import_module(f"{pkg}.cli.companion")
    return ns


JAX = _namespace("imagined_speech_translation_tpu")
PORT = _namespace("imagined_speech_translation_tpu_torch")


def run(coro):
    return asyncio.run(coro)


def make_client(ns, authenticator=None, prefs=None):
    bundle = ns.rt.services.ServiceBundle()
    reg = ns.rt.commands.build_command_registry(
        bundle, registry=ns.rt.session.SessionRegistry(authenticator=authenticator))
    service = ns.rt.server.WssService(reg, services=bundle)
    return ns.c.CompanionClient(ns.c.InProcessTransport(service), prefs), bundle


# ---------------------------------------------------------------------------
# tests/test_companion.py: sign-in, profile helpers, the request discipline
# ---------------------------------------------------------------------------


def sc_sign_in_full_flow_first_login(ns, tmp):
    client, bundle = make_client(ns)
    key = run(client.sign_in("id-token-alice", server_auth_code="4/abc",
                             email="alice@example.com",
                             documents=[f"doc {i}" for i in range(120)]))
    assert key and client.access_key == key
    assert client.prefs.get_bool("logged") is True
    assert client.prefs.get_bool("first_time", default=True) is False
    assert client.auto_login() is True
    refresh = run(client.get_refresh_token())
    assert refresh
    profile = run(bundle.store.get("profile:id-token-alice"))
    assert profile
    return [refresh[:3], profile, client.prefs.snapshot()]


def sc_sign_in_second_login_skips_upload(ns, tmp):
    client, bundle = make_client(ns)
    run(client.sign_in("tok", email="a@b.c", documents=["d1"]))
    first = run(bundle.store.get("profile:tok"))
    client2 = ns.c.CompanionClient(client.transport, ns.c.Preferences())
    run(client2.sign_in("tok", email="a@b.c", documents=["d2"]))
    assert run(bundle.store.get("profile:tok")) == first
    assert client2.prefs.get_bool("logged") is True
    return [first, client2.prefs.snapshot()]


def sc_sign_in_rejected_rolls_back(ns, tmp):
    async def deny(token):
        return None

    prefs = ns.c.Preferences()
    prefs.set("logged", True)
    client, _ = make_client(ns, authenticator=deny, prefs=prefs)
    with pytest.raises(ns.c.AuthenticationError) as ei:
        run(client.sign_in("bad-token"))
    assert ns.client.NOT_PURCHASED_MESSAGE in str(ei.value)
    assert client.access_key == "" and prefs.get_bool("logged") is False
    assert client.auto_login() is False
    return [str(ei.value), prefs.snapshot()]


def sc_sign_out_and_forged_key(ns, tmp):
    client, _ = make_client(ns)
    run(client.sign_in("tok"))
    client.sign_out()
    assert client.access_key == "" and client.auto_login() is False
    client.access_key = "forged"
    got = outcome(run, client.request("get_display_name"))
    assert got[:2] == ("raises", "AuthenticationError")
    return got


def sc_profile_helpers_and_ble_id_roundtrip(ns, tmp):
    client, _ = make_client(ns)
    run(client.sign_in("tok-u1"))
    out = [run(client.get_display_name()), run(client.get_auth_code())]
    run(client.set_ble_id("AA:BB:CC"))
    out.append(run(client.get_ble_id()))
    assert out == ["tok-u1", None, "AA:BB:CC"]
    return out


def sc_send_data_conversation(ns, tmp):
    client, _ = make_client(ns)
    run(client.sign_in("tok"))
    reply = run(client.request("send_data", ("hello there",)))
    assert isinstance(reply, dict) and reply.get("response")
    return reply


def sc_interleaved_async_frames_are_buffered(ns, tmp):
    class Interleaving:
        def __init__(self):
            self.queue = []

        async def send(self, message):
            self.queue.append("utterance¬¬decoded words")
            self.queue.append('ok¬speak¬{"spoken": "hi"}')

        async def receive(self):
            return self.queue.pop(0)

        async def close(self):
            pass

    client = ns.c.CompanionClient(Interleaving())
    result = run(client.request("speak", ("hi",)))
    assert result == {"spoken": "hi"}
    assert [e.command for e in client.events] == ["utterance"]
    return [result, [(e.command, e.args) for e in client.events]]


def sc_unknown_command_is_companion_error(ns, tmp):
    client, _ = make_client(ns)
    run(client.sign_in("tok"))
    got = outcome(run, client.request("no_such_command"))
    assert got[0] == "raises"
    with pytest.raises(ns.c.CompanionError):
        run(client.request("no_such_command"))
    return got


def sc_sign_in_without_documents_keeps_first_login_pending(ns, tmp):
    client, bundle = make_client(ns)
    run(client.sign_in("tok-pending", email="p@x.y"))
    out = [run(bundle.store.get("profile:tok-pending"))]
    assert out[0] in (None, [], "")
    client2 = ns.c.CompanionClient(client.transport, ns.c.Preferences())
    run(client2.sign_in("tok-pending", email="p@x.y", documents=["memo"]))
    out.append(run(bundle.store.get("profile:tok-pending")))
    assert out[1]
    client3 = ns.c.CompanionClient(client.transport, ns.c.Preferences())
    run(client3.sign_in("tok-pending", email="p@x.y", documents=["other"]))
    out.append(run(bundle.store.get("profile:tok-pending")))
    assert "other" not in str(out[2])
    return out


def sc_in_process_transport_needs_a_frame_first(ns, tmp):
    t = ns.c.InProcessTransport(None)
    return [outcome(run, t.receive()), outcome(run, t.close())]


# ---------------------------------------------------------------------------
# BLE pairing and dispatch, phone relays, the blind-support toggle
# ---------------------------------------------------------------------------


def _link(ns, prefs=None, phone_services=None):
    radio = ns.c.InMemoryBle(devices={"glasses-1": object()})
    prefs = prefs or ns.c.Preferences()
    link = ns.c.BleLink(radio, ble_id="glasses-1", auth_key="K", prefs=prefs)
    if phone_services is not None:
        link.phone = ns.c.PhoneActions(phone_services, "K", link.write_data)
    return link, radio, prefs


def sc_ble_scan_and_pair(ns, tmp):
    link, radio, _ = _link(ns)
    found = run(link.scan_devices())
    assert found is True and link.connected and radio.connected_to is not None
    other = ns.c.BleLink(ns.c.InMemoryBle(devices={"other": object()}), ble_id="glasses-1",
                         auth_key="K", prefs=ns.c.Preferences())
    assert run(other.scan_devices()) is False and not other.connected
    absent = run(ns.ble.pair(ns.c.InMemoryBle(), ble_id="x", auth_key="K",
                             prefs=ns.c.Preferences(), retries=2))
    assert absent is None
    return [found, link.connected, other.connected, absent]


def sc_ble_dispatch_state_frames(ns, tmp):
    link, radio, prefs = _link(ns)
    for frame in (b"ip|K|192.168.4.7", b"volume|K|7", b"battery|K|83"):
        run(radio.emit_notify(frame))
    assert prefs.get_string("ip") == "192.168.4.7"
    assert link.volume == 7 and link.battery == 83
    return [prefs.snapshot(), link.volume, link.battery]


def sc_ble_drops_bad_auth_and_malformed(ns, tmp):
    link, radio, prefs = _link(ns)
    for frame in (b"ip|WRONGKEY|10.0.0.1", b"justonepart", b"\xff\xfe|K|x",
                  b"volume|K|not-an-int"):
        run(radio.emit_notify(frame))
    assert prefs.get_string("ip") is None and link.volume == 0
    return [prefs.snapshot(), link.volume, radio.written]


def sc_ble_auto_reconnect_on_disconnect(ns, tmp):
    link, radio, _ = _link(ns)
    run(link.scan_devices())
    run(radio.emit_state("disconnected"))
    assert link.connected is True
    return link.connected


def _phone(ns, contacts=(), permission=True):
    services = ns.c.InMemoryPhone(contacts=tuple(contacts), contacts_permission=permission)
    writes = []

    async def write(data):
        writes.append(data)

    return ns.c.PhoneActions(services, "K", write), services, writes


def sc_contacts_lookups(ns, tmp):
    out = []
    for contacts, permission, query in (
            ([ns.c.Contact("Ada Lovelace", ("+44123",))], True, "ada lovelace"),
            ([ns.c.Contact("Ada Lovelace")], True, "Ada Lovelace"),
            ([ns.c.Contact("Bob", ("+1",))], True, "Carol"),
            ((), False, "Anyone")):
        actions, _, writes = _phone(ns, contacts, permission)
        run(actions.contacts(query))
        out.append(writes)
    assert out == [
        ["contacts|K|+44123"],
        ["contacts|K|I couldn't find any matching phone number with Ada Lovelace"],
        ["contacts|K|I couldn't find any matching contact with Carol"],
        ["contacts|K|Please grant me permission to access your contacts"]]
    return out


def sc_call_and_text_relays(ns, tmp):
    actions, services, writes = _phone(ns)
    run(actions.call("+15550100"))
    run(actions.text("+15550100", "on my way"))
    assert services.calls == ["+15550100"]
    assert services.sms == [("on my way", ("+15550100",))]
    assert writes == ["call|K|", "text|K|"]
    return [services.calls, services.sms, writes]


def sc_ble_routes_phone_commands(ns, tmp):
    services = ns.c.InMemoryPhone(contacts=(ns.c.Contact("Eve", ("+49",)),))
    link, radio, _ = _link(ns, phone_services=services)
    for frame in (b"contacts|K|Eve", b"call|K|+49", b"text|K|+49|hello"):
        run(radio.emit_notify(frame))
    assert services.calls == ["+49"] and services.sms == [("hello", ("+49",))]
    assert radio.written[0] == b"contacts|K|+49"
    return [services.calls, services.sms, radio.written]


def sc_set_blind_support_pref_and_device_frame(ns, tmp):
    writes = []

    async def device_write(data):
        writes.append(data)

    client, _ = make_client(ns)
    client._device_write = device_write
    run(client.sign_in("tok"))
    run(client.set_blind_support(True))
    assert client.prefs.get_bool("blind_support") is True
    run(client.set_blind_support(False))
    key = client.access_key
    assert writes == [f"blind|{key}|true", f"blind|{key}|false"]
    return [w.replace(key, "<key>") for w in writes]


def sc_pair_retries_when_connect_fails(ns, tmp):
    ble = ns.c.InMemoryBle(devices={"AA:BB": object()})
    fails = [2]
    orig_connect = ble.connect

    async def flaky_connect(device):
        if fails[0] > 0:
            fails[0] -= 1
            raise OSError("gatt error")
        await orig_connect(device)

    ble.connect = flaky_connect
    link = run(ns.ble.pair(ble, ble_id="AA:BB", auth_key="k", prefs=ns.c.Preferences(),
                           retries=3))
    assert link is not None and link.connected

    ble2 = ns.c.InMemoryBle(devices={"AA:BB": object()})

    async def always_fail(device):
        raise OSError("gatt error")

    ble2.connect = always_fail
    dead = run(ns.ble.pair(ble2, ble_id="AA:BB", auth_key="k", prefs=ns.c.Preferences(),
                           retries=2))
    assert dead is None
    return [link.connected, fails, dead]


# ---------------------------------------------------------------------------
# WiFi liveness, preferences
# ---------------------------------------------------------------------------


def sc_wifi_liveness(ns, tmp):
    out = [run(ns.c.is_online(ns.c.Preferences()))]
    prefs = ns.c.Preferences()
    prefs.set("ip", "10.0.0.9")
    calls = []

    def getter(status=200, raise_exc=None):
        async def get(url, timeout):
            calls.append(url)
            if raise_exc:
                raise raise_exc
            return status

        return get

    out += [run(ns.c.is_online(prefs, http_get=getter(200))),
            run(ns.c.is_online(prefs, http_get=getter(503))),
            run(ns.c.is_online(prefs, http_get=getter(raise_exc=OSError())))]

    async def hang(url, timeout):
        await asyncio.sleep(30)
        return 200

    out.append(run(ns.c.is_online(prefs, http_get=hang, timeout=0.05)))
    assert out == [False, True, False, False, False]
    assert calls[0] == "http://10.0.0.9"
    return [out, calls, ns.wifi.TIMEOUT_SECONDS]


def sc_prefs_roundtrip_and_types(ns, tmp):
    p = tmp / "prefs.json"
    prefs = ns.c.Preferences(p)
    prefs.set("logged", True)
    prefs.set("ip", "1.2.3.4")
    prefs.set("volume", 7)
    again = ns.c.Preferences(p)
    out = [again.get_bool("logged"), again.get_string("ip"), again.get_int("volume"),
           again.get_string("logged"), again.get_int("logged")]
    assert out == [True, "1.2.3.4", 7, None, 0]
    again.remove("ip")
    assert ns.c.Preferences(p).get_string("ip") is None
    return [out, p.read_text()]


def sc_prefs_corrupt_file_recovers_and_memory_only(ns, tmp):
    p = tmp / "prefs.json"
    p.write_text("{not json")
    prefs = ns.c.Preferences(p)
    assert prefs.get_bool("logged") is False
    prefs.set("logged", True)
    assert json.loads(p.read_text()) == {"logged": True}
    mem = ns.c.Preferences()
    mem.set("k", "v")
    assert mem.get_string("k") == "v"
    return [p.read_text(), mem.snapshot()]


# ---------------------------------------------------------------------------
# the recordings browser over Drive, the settings panel
# ---------------------------------------------------------------------------


def _created_time_free(files):
    return [{k: v for k, v in f.items() if k != "createdTime"} for f in files]


def sc_recordings_find_or_create_and_crud(ns, tmp):
    drive = ns.c.InMemoryDrive()
    b = ns.c.RecordingsBrowser(drive)

    async def flow():
        folder = await b.ensure_media_folder()
        assert folder["name"] == "Gemini Sight Media"
        b2 = ns.c.RecordingsBrowser(drive)
        assert (await b2.ensure_media_folder())["id"] == folder["id"]
        assert len([f for f in drive.files.values() if f["mimeType"].endswith("folder")]) == 1
        url = await b.folder_url()
        assert url == "https://drive.google.com/drive/u/2/folders/" + folder["id"]
        m1 = await b.save_recording("a.avi", b"AAAA")
        m2 = await b.save_recording("b.avi", b"BB")
        drive.files[m2["id"]]["createdTime"] = "2030-01-01T00:00:00Z"
        names = [f["name"] for f in await b.list_recordings()]
        assert names == ["b.avi", "a.avi"]
        assert await drive.download(m1["id"]) == b"AAAA"
        await b.delete(m1["id"])
        after = [f["name"] for f in await b.list_recordings()]
        assert after == ["b.avi"]
        return [_created_time_free([folder, m1, m2]), url, names, after]

    return run(flow())


def sc_google_drive_wire_format(ns, tmp):
    calls = []

    async def http(method, url, headers=None, body=None):
        calls.append((method, url, headers or {}, body))
        if method == "GET" and "files?q=" in url:
            return 200, json.dumps({"files": []}).encode()
        if method == "POST":
            return 200, json.dumps({"id": "fid1", "name": "x"}).encode()
        if method == "DELETE":
            return 204, b""
        if url.endswith("alt=media"):
            return 200, b"MEDIA"
        return 404, b"?"

    drive = ns.c.GoogleDrive(http, token="tok123")
    b = ns.c.RecordingsBrowser(drive)

    async def flow():
        await b.ensure_media_folder()
        await b.save_recording("clip.avi", b"BYTES", mime="video/avi")
        assert await drive.download("fid9") == b"MEDIA"
        await drive.delete("fid9")

    run(flow())
    m, url, hdrs, _ = calls[0]
    q = urllib.parse.parse_qs(urllib.parse.urlsplit(url).query)["q"][0]
    assert m == "GET" and q == (
        "mimeType='application/vnd.google-apps.folder' and "
        "name='Gemini Sight Media' and trashed=false and 'root' in parents")
    assert hdrs["Authorization"] == "Bearer tok123"
    assert calls[1][0] == "POST" and json.loads(calls[1][3])["mimeType"].endswith("folder")
    assert b'"parents": ["fid1"]' in calls[2][3] and b"BYTES" in calls[2][3]
    assert calls[3][1].endswith("/files/fid9?alt=media")
    assert calls[4][0] == "DELETE" and calls[4][1].endswith("/files/fid9")
    # a multipart boundary may be random: compare the upload's shape
    m, url, hdrs, body = calls[2]
    boundary = hdrs["Content-Type"].split("boundary=")[-1]
    upload = (m, url, hdrs["Content-Type"].replace(boundary, "<b>"),
              body.replace(boundary.encode(), b"<b>"))
    return [calls[:2], upload, calls[3:]]


def sc_local_dir_drive_persists(ns, tmp):
    async def flow():
        b = ns.c.RecordingsBrowser(ns.c.LocalDirDrive(tmp / "drv"))
        meta = await b.save_recording("c.avi", b"XYZ")
        b2 = ns.c.RecordingsBrowser(ns.c.LocalDirDrive(tmp / "drv"))
        got = await b2.list_recordings()
        assert [f["id"] for f in got] == [meta["id"]]
        data = await b2.drive.download(meta["id"])
        assert data == b"XYZ"
        await b2.delete(meta["id"])
        assert await b2.list_recordings() == []
        return [_created_time_free([meta] + got), data]

    return run(flow())


def sc_settings_panel_surface(ns, tmp):
    prefs = ns.c.Preferences(tmp / "p.json")
    client, _ = make_client(ns, prefs=prefs)
    written = []

    async def device_write(frame):
        written.append(frame)

    client._device_write = device_write
    panel = ns.c.SettingsPanel(client)

    async def flow():
        key = await client.sign_in("tok", email="user@example.com", documents=[])
        info = await panel.user_info()
        assert info["email"] == "user@example.com"
        await panel.connect_wifi("HomeNet", "hunter2")
        assert written == [f"wifi|{key}|HomeNet|hunter2"]
        device = panel.device_info()
        assert device["model"]
        panel.set("ip", "192.168.1.7")
        assert panel.get("ip") == "192.168.1.7"
        assert panel.all()["logged"] is True
        panel.sign_out()
        assert prefs.get_bool("logged") is False
        return [info, [w.replace(key, "<key>") for w in written], device, panel.all()]

    out = run(flow())
    bare, _ = make_client(ns, prefs=ns.c.Preferences(tmp / "q.json"))
    with pytest.raises(RuntimeError, match="no device"):
        run(ns.c.SettingsPanel(bare).connect_wifi("x", "y"))
    return out


# ---------------------------------------------------------------------------
# tests/test_companion_ui.py: the QR encoder and the device page over HTTP
# ---------------------------------------------------------------------------


def sc_qr_structure_and_scaling(ns, tmp):
    qr = ns.qr
    m = qr.encode("HELLO")
    assert len(m) == 21 and all(len(r) == 21 for r in m)
    assert all(m[r][c] == 1 for r, c in ((3, 3), (3, 17), (17, 3))) and m[len(m) - 8][8] == 1
    svg = qr.to_svg(m)
    assert svg.startswith("<svg") and "rect" in svg and "██" in qr.to_ascii(m)
    sizes = [len(qr.encode("x" * n)) for n in (10, 100, 213)]
    assert sizes == [21, 41, 57]
    with pytest.raises(ValueError):
        qr.encode("x" * 214)
    return [m, svg, qr.to_ascii(m), sizes]


def sc_qr_cv2_roundtrip(ns, tmp):
    cv2 = pytest.importorskip("cv2")
    det = cv2.QRCodeDetector()
    out = []
    for p in ("WIFI:T:WPA;S:glasses-net;P:secret123;;",
              "https://example.com/pair?device=ist-0001", "x" * 120,
              "中文字符串测试 one two three"):
        m = ns.qr.encode(p)
        arr = 255 * (1 - np.array(m, dtype=np.uint8))
        big = np.kron(np.pad(arr, 4, constant_values=255), np.ones((8, 8), np.uint8))
        txt, _, _ = det.detectAndDecode(big)
        assert txt == p, f"cv2 could not decode {p[:30]!r}"
        out.append(m)
    return out


@contextlib.contextmanager
def ui_server(ns, tmp, **kw):
    prefs = ns.c.Preferences(tmp / "prefs.json")
    prefs.set("email", "user@example.com")
    ui = ns.c.DeviceUI(prefs, tmp / "drive", **kw)
    srv = ns.webui.serve(ui, "127.0.0.1", 0)  # an ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield ui, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(url, obj=None):
    req = urllib.request.Request(url, data=json.dumps(obj or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def sc_page_and_state(ns, tmp):
    with ui_server(ns, tmp) as (ui, base):
        status, ctype, page = _get(base + "/")
        assert status == 200 and ctype == "text/html"
        assert b"Imagined Speech Glasses" in page and b"Blind Support" in page
        s0 = json.loads(_get(base + "/api/state")[2])
        assert s0["ble"] is False and s0["wifi"] is False
        assert s0["email"] == "user@example.com"
        ui.prefs.set("ip", "192.168.4.21")
        s1 = json.loads(_get(base + "/api/state")[2])
        assert s1["wifi"] is True and s1["cast_url"] == "https://192.168.4.21:81/"
        missing = outcome(_get, base + "/no/such/page")
    return [status, ctype, page, s0, s1, missing]


def sc_blind_toggle_and_settings(ns, tmp):
    with ui_server(ns, tmp) as (ui, base):
        toggles = [_post(base + "/api/blind")["blind_support"] for _ in range(2)]
        assert toggles == [True, False] and ui.prefs.get_bool("blind_support") is False
        out = _post(base + "/api/settings", {"key": "volume_step", "value": "5"})
        assert out["settings"]["volume_step"] == "5"
        s = json.loads(_get(base + "/api/settings")[2])
        assert s["device"]["model"] and s["settings"]["volume_step"] == "5"
    return [toggles, out, s]


def sc_wifi_qr_surface(ns, tmp):
    with ui_server(ns, tmp) as (_, base):
        out = _post(base + "/api/wifi", {"ssid": "lab", "password": "pw123"})
        assert out["pushed"] is False
        assert out["payload"].startswith("WIFI:T:WPA;S:lab;")
        assert out["qr_svg"].startswith("<svg")
        status, ctype, body = _get(base + "/api/qr?text=hello")
        assert status == 200 and ctype == "image/svg+xml" and b"<svg" in body
    return [out, status, ctype, body]


def sc_wifi_pushes_over_ble_when_paired(ns, tmp):
    writes = []

    async def write(frame):
        writes.append(frame)

    ui = ns.c.DeviceUI(ns.c.Preferences(tmp / "p.json"), tmp / "d", device_write=write,
                       auth_key="k1")
    out = ui.wifi("lab", "pw")
    assert out["pushed"] is True and writes == ["wifi|k1|lab|pw"]
    return [out, writes]


def sc_recordings_browser_surface(ns, tmp):
    with ui_server(ns, tmp) as (_, base):
        saved = _post(base + "/api/recordings/save",
                      {"name": "a.avi", "content_b64": base64.b64encode(b"xyz").decode()})
        saved = saved["saved"]
        recs = json.loads(_get(base + "/api/recordings")[2])
        assert [f["name"] for f in recs["recordings"]] == ["a.avi"]
        assert recs["url"].startswith("https://drive.google.com/")
        status, _, body = _get(base + "/api/recordings/download?id="
                               + urllib.parse.quote(saved["id"]))
        assert status == 200 and body == b"xyz"
        _post(base + "/api/recordings/delete", {"id": saved["id"]})
        after = json.loads(_get(base + "/api/recordings")[2])
        assert after["recordings"] == []
    return [_created_time_free([saved] + recs["recordings"]), recs["url"], body, after]


# ---------------------------------------------------------------------------
# tests/test_runtime_adapters.py and tests/test_runtime_loop.py
# ---------------------------------------------------------------------------


class FakeHttp:
    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    async def __call__(self, method, url, json=None, headers=None):
        self.calls.append({"method": method, "url": url, "json": json})
        status, body = self.responses.pop(0)
        if isinstance(body, (dict, list)):
            import json as j

            body = j.dumps(body).encode()
        return status, body


def gemini_reply(text):
    return {"candidates": [{"content": {"role": "model", "parts": [{"text": text}]}}]}


def _wav(pcm: bytes, rate=24000) -> bytes:
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
    hdr += struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(pcm)) + pcm


def sc_gemini_chat_vision_and_errors(ns, tmp):
    ad = ns.rt.adapters
    http = FakeHttp([(200, gemini_reply("hi!")), (200, gemini_reply("again")),
                     (200, gemini_reply("a cat"))])
    llm = ad.GeminiLLM(http, "KEY", system_prompt="teach the ¬ DSL")

    async def flow():
        return [await llm.chat("s1", "hello"), await llm.chat("s1", "more"),
                await llm.describe_image(b"\xff\xd8jpegbytes", "what?")]

    replies = run(flow())
    assert replies == ["hi!", "again", "a cat"]
    first, second, vision = http.calls
    assert "generateContent" in first["url"] and "key=KEY" in first["url"]
    assert [c["role"] for c in second["json"]["contents"]] == ["user", "model", "user"]
    parts = vision["json"]["contents"][0]["parts"]
    assert parts[0]["inline_data"]["mime_type"] == "image/jpeg" and parts[1]["text"] == "what?"

    quota = ad.GeminiLLM(FakeHttp([(429, b'{"error": {"message": "quota"}}')]), "KEY")
    with pytest.raises(ad.CloudError) as e:
        run(quota.generate("x"))
    assert e.value.status == 429

    http2 = FakeHttp([(500, b"boom"), (200, gemini_reply("ok"))])
    llm2 = ad.GeminiLLM(http2, "KEY")

    async def after_error():
        failed = await asyncio.gather(llm2.chat("s", "first"), return_exceptions=True)
        return [type(failed[0]).__name__, str(failed[0]), await llm2.chat("s", "second")]

    recovered = run(after_error())
    contents = http2.calls[1]["json"]["contents"]
    assert [c["parts"][0]["text"] for c in contents] == ["second"]
    return [replies, http.calls, e.value.status, str(e.value), recovered, http2.calls]


def sc_tts_stt_and_cache(ns, tmp):
    ad = ns.rt.adapters
    pcm = struct.pack("<4h", 1, -2, 3, -4)
    http = FakeHttp([(200, {"audioContent": base64.b64encode(_wav(pcm)).decode()})])
    out = [run(ad.GoogleCloudTTS(http, "KEY").synthesize("hello", "alice"))]
    assert out[0] == pcm
    req = http.calls[0]["json"]
    assert req["voice"]["name"] == "en-US-Journey-O"
    assert req["audioConfig"]["audioEncoding"] == "LINEAR16"

    pcm2 = b"\x01\x02" * 8
    http2 = FakeHttp([(200, {"audioContent": base64.b64encode(_wav(pcm2)).decode()})])
    tts = ns.rt.services.CachingTTS(ad.GoogleCloudTTS(http2, "KEY"))

    async def twice():
        return [await tts.synthesize("hi", "u"), await tts.synthesize("hi", "u")]

    out.append(run(twice()))
    assert out[1] == [pcm2, pcm2] and len(http2.calls) == 1

    http3 = FakeHttp([(200, {"results": [{"alternatives": [{"transcript": "hello"}]},
                                         {"alternatives": [{"transcript": "world"}]}]})])
    out.append(run(ad.GoogleCloudSTT(http3, "KEY").transcribe(b"\x00\x01" * 100)))
    assert out[2] == "hello world"
    assert http3.calls[0]["json"]["config"]["encoding"] == "LINEAR16"
    return [out, http.calls, http2.calls, http3.calls]


def sc_maps_place_directions_and_encoding(ns, tmp):
    ad = ns.rt.adapters
    http = FakeHttp([
        (200, {"candidates": [{"name": "Cafe X", "formatted_address": "1 Main St",
                               "geometry": {"location": {"lat": 1.0, "lng": 2.0}}}]}),
        (200, {"routes": [{"legs": [{"steps": [{"html_instructions": "Turn <b>left</b>"},
                                               {"html_instructions": "Go <i>straight</i>"}]}]}]}),
        (200, {"candidates": []}), (200, {"routes": []})])
    maps = ad.GoogleMaps(http, "KEY")

    async def flow():
        return [await maps.find_place("coffee", near="Rome"), await maps.directions("A", "B"),
                await maps.find_place("Fish & Chips", near="Tel Aviv"),
                await maps.directions("A&B #1", "C D")]

    out = run(flow())
    assert out[0]["name"] == "Cafe X" and out[1] == ["Turn left", "Go straight"]
    assert "coffee%20near%20Rome" in http.calls[0]["url"]
    assert "Fish%20%26%20Chips" in http.calls[2]["url"]
    assert "origin=A%26B%20%231&destination=C%20D" in http.calls[3]["url"]
    return [out, http.calls]


def sc_jwt_malformed_claims_rejected_not_raised(ns, tmp):
    import hashlib
    import hmac

    auth = ns.rt.auth

    def b64(raw):
        return base64.urlsafe_b64encode(raw).decode().rstrip("=")

    si = b64(json.dumps({"alg": "HS256"}).encode()) + "." + b64(b"[1,2]")
    sig = b64(hmac.new(b"s", si.encode(), hashlib.sha256).digest())
    tok = auth.sign_token({"email": "a@b", "exp": "soon"}, "s", ttl_s=None)
    out = [auth.verify_token(si + "." + sig, "s"), auth.verify_token(tok, "s")]
    assert out == [None, None]
    return out


def sc_adapters_satisfy_service_bundle(ns, tmp):
    http = FakeHttp([(200, gemini_reply("dsl: speak(|ok|)"))])
    bundle = ns.rt.services.ServiceBundle(llm=ns.rt.adapters.GeminiLLM(http, "KEY"))
    reg = ns.rt.commands.build_command_registry(bundle)
    TextFrame = ns.rt.protocol.TextFrame

    async def flow():
        key = await reg.dispatch(TextFrame("authentication", "tok"))
        return await reg.dispatch(TextFrame("process", key, ("do it",)))

    out = run(flow())
    assert out["response"] == "dsl: speak(|ok|)"
    return [out, [c["json"] for c in http.calls]]


def sc_reminder_loop_fires_within_lead(ns, tmp):
    from datetime import datetime, timedelta

    bundle = ns.rt.services.ServiceBundle()
    spoken = []

    async def announce(text):
        spoken.append(text)

    now = datetime(2026, 8, 16, 12, 0, 0)
    loop = ns.rt.reminders.ReminderLoop(bundle.personal, announce, lead_seconds=300,
                                        clock=lambda: now.timestamp())

    async def flow():
        for title, delta in (("Soon", timedelta(minutes=3)), ("Later", timedelta(hours=2)),
                             ("Past", timedelta(minutes=-1))):
            at = (now + delta).isoformat()
            await bundle.personal.add_event(title, at, at)
        await bundle.personal.add_event("Undated", "not a date", "")
        fired = await loop.check_once()
        assert len(fired) == 1 and "Soon" in spoken[0]
        again = await loop.check_once()
        assert again == []
        task = loop.start()
        await asyncio.sleep(0)
        loop.stop()
        return [len(fired), again, task.cancelling() > 0 or task.cancelled()]

    return [run(flow()), spoken]


def sc_ppm_and_mux_fallback(ns, tmp):
    media = ns.rt.media
    frame = np.zeros((4, 6, 3), np.uint8)
    frame[..., 0] = 255
    media.write_ppm(tmp / "f.ppm", frame)
    data = (tmp / "f.ppm").read_bytes()
    assert data.startswith(b"P6\n6 4\n255\n") and len(data) == 11 + 4 * 6 * 3
    bad = outcome(media.write_ppm, tmp / "g.ppm", np.zeros((2, 2, 4), np.uint8))
    va = media.VideoAssembler()
    va.add_frame(frame)
    va.add_audio(b"\x00\x00" * 100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(media.VideoAssembler, "ffmpeg_available", staticmethod(lambda: False))
        out = va.mux(tmp / "video.mp4")
    assert out.suffix == ".raw"
    parts = sorted((p.name, p.read_bytes()) for p in out.iterdir())
    assert dict(parts)["audio.pcm"] == b"\x00\x00" * 100
    return [data, bad, out.name, parts]


SCENARIOS = [v for k, v in list(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_companion_scenario_matches_jax(scenario, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert scenario(PORT, tmp_path / "port") == scenario(JAX, tmp_path / "jax")


# ---------------------------------------------------------------------------
# cli.companion's offline surfaces
# ---------------------------------------------------------------------------


def _cli(ns, tmp, argv):
    """``cli.companion.main(argv)``: its exit code (or ``SystemExit`` code),
    stdout and stderr, with the scratch directory written as ``<tmp>``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = ns.cli.main(argv)
        except SystemExit as e:
            code = ("exit", e.code)
    text = [s.getvalue().replace(str(tmp), "<tmp>") for s in (out, err)]
    return code, *text


def _cli_session(ns, tmp):
    prefs, drive = str(tmp / "prefs.json"), str(tmp / "drive")
    (tmp / "clip.avi").write_bytes(b"CLIP")
    local = ["--prefs", prefs, "--drive-dir", drive]
    runs = [
        local + ["--settings-set", "volume_step=5", "--settings-set", "blind_support=true",
                 "--settings-set", "logged=False", "--settings"],
        local + ["--settings"],
        local + ["--wifi", "Home;Net:pa,ss:word"],
        local + ["--save-recording", str(tmp / "clip.avi"), "--recordings", "--recordings-url"],
        local + ["--download-recording", "Gemini Sight Media/clip.avi",
                 "--dest", str(tmp / "out.avi")],
        local + ["--download-recording", "Gemini Sight Media/clip.avi"],
        local + ["--delete-recording", "Gemini Sight Media/clip.avi", "--recordings"],
        local,
        ["--help"],
    ]
    out = []
    for argv in runs:
        code, stdout, stderr = _cli(ns, tmp, argv)
        try:
            parsed = json.loads(stdout)
        except ValueError:
            parsed = stdout
        if isinstance(parsed, dict):
            for key in ("recordings", "saved"):
                if key in parsed:
                    got = parsed[key]
                    parsed[key] = _created_time_free(got if isinstance(got, list) else [got])
        out.append((code, parsed, stderr))
    out.append((tmp / "out.avi").read_bytes())
    return out


def test_companion_cli_offline_surfaces_match_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _cli_session(PORT, tmp_path / "port")
    assert got == _cli_session(JAX, tmp_path / "jax")
    settings, again, wifi, saved, downloaded, no_dest, deleted, nothing, usage, data = got
    assert settings[1]["settings"] == {"volume_step": "5", "blind_support": True,
                                      "logged": False}
    assert again[1] == settings[1]
    assert wifi[1]["wifi_qr"].startswith("WIFI:T:WPA;S:Home\\;Net;")
    assert [f["name"] for f in saved[1]["recordings"]] == ["clip.avi"]
    assert downloaded[0] == 0 and data == b"CLIP"
    assert no_dest[0] == 2 and "--dest" in no_dest[2]
    assert deleted[1]["recordings"] == []
    assert nothing[0] == ("exit", 2) and "--token is required" in nothing[2]
    assert usage[0] == ("exit", 0) and "--settings-set" in usage[1]


def test_webui_main_serves_the_page(tmp_path, monkeypatch):
    """``companion.webui.main`` wires the page as the JAX one does: the
    server it starts (moved to an ephemeral port) answers ``/api/state`` the
    same in both packages."""
    out = []
    for ns in (PORT, JAX):
        real, served = ns.webui.serve, {}

        def once(ui, host, port, real=real, served=served):
            srv = real(ui, "127.0.0.1", 0)
            served["args"] = (host, port)

            class Once:  # answers one request, then stops
                def serve_forever(self):
                    t = threading.Thread(target=srv.serve_forever, daemon=True)
                    t.start()
                    try:
                        url = f"http://127.0.0.1:{srv.server_address[1]}/api/state"
                        served["state"] = json.loads(_get(url)[2])
                    finally:
                        srv.shutdown()
                        srv.server_close()
                        t.join()

            return Once()

        monkeypatch.setattr(ns.webui, "serve", once)
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            code = ns.webui.main(["--prefs", str(tmp_path / "p.json"),
                                  "--drive-dir", str(tmp_path / "d"), "--port", "8123"])
        out.append((code, stdout.getvalue(), served["args"], served["state"]))
    assert out[0] == out[1]
    assert out[0][:3] == (0, "device page on http://127.0.0.1:8123/\n", ("127.0.0.1", 8123))


# ---------------------------------------------------------------------------
# the copies' code and exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("__init__",) + COMPANION + ("cli.companion",))
def test_copied_module_code_is_the_original(name):
    def module(ns):
        return {"__init__": ns.c, "cli.companion": ns.cli}.get(name) or getattr(ns, name)

    assert _code(module(PORT)) == _code(module(JAX))


def test_companion_package_exports_match():
    assert PORT.c.__all__ == JAX.c.__all__
    assert {n for n in dir(PORT.c) if not n.startswith("_")} == \
        {n for n in dir(JAX.c) if not n.startswith("_")}
