"""Headless companion CLI — the app's user journey without the widgets.

Drives the full client flow from ``app/lib`` against a running control
plane (``cli.serve`` / :mod:`..runtime.server`): sign in with an id token,
persist the auth-code exchange, first-login personalization upload from a
directory of text files, then report device status (BLE pref'd id, WiFi
liveness, blind-support toggle) and optionally hold a short conversation
via ``send_data``.

Usage::

    python -m imagined_speech_translation_tpu_torch.cli.companion \
        --url ws://127.0.0.1:4040 --token <id-token> \
        [--auth-code CODE] [--email you@example.com] \
        [--personalize-dir DIR] [--prefs ~/.ist_companion.json] \
        [--blind on|off] [--say "hello"]

Device-page surfaces (``app/lib/pages/device.dart`` / ``settings.dart``)
work WITHOUT a server connection (no ``--token``):

* recordings browser over a Drive store (``--drive-dir`` selects the
  filesystem twin): ``--recordings``, ``--recordings-url``,
  ``--save-recording FILE``, ``--download-recording ID --dest PATH``,
  ``--delete-recording ID``;
* settings: ``--settings`` (dump), ``--settings-set KEY=VALUE`` (repeat),
  ``--wifi SSID:PASSWORD`` prints the provisioning ``WIFI:`` QR payload
  the device page renders for the glasses camera.

A copy of ``imagined_speech_translation_tpu.cli.companion`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

from ..companion import (
    AuthenticationError,
    CompanionClient,
    LocalDirDrive,
    Preferences,
    RecordingsBrowser,
    WebsocketTransport,
    is_online,
)


def iter_documents(directory: Path):
    for p in sorted(directory.rglob("*.txt")):
        yield p.read_text(errors="replace")


async def run_local(args) -> int:
    """Device-page surfaces that need no control-plane connection."""
    out: dict = {}
    prefs = Preferences(args.prefs)

    if args.settings_set:
        for kv in args.settings_set:
            key, _, val = kv.partition("=")
            parsed = {"true": True, "false": False}.get(val.lower(), val)
            prefs.set(key, parsed)
    if args.settings:
        out["settings"] = prefs.snapshot()
    if args.wifi:
        from ..runtime.personalization import wifi_qr_payload

        ssid, _, password = args.wifi.partition(":")
        out["wifi_qr"] = wifi_qr_payload(ssid, password)

    needs_drive = (
        args.recordings or args.recordings_url or args.save_recording
        or args.download_recording or args.delete_recording
    )
    if needs_drive:
        browser = RecordingsBrowser(LocalDirDrive(args.drive_dir))
        if args.save_recording:
            src = Path(args.save_recording)
            meta = await browser.save_recording(src.name, src.read_bytes())
            out["saved"] = meta
        if args.download_recording:
            if not args.dest:
                print("--download-recording needs --dest", file=sys.stderr)
                return 2
            p = await browser.download_to(args.download_recording, args.dest)
            out["downloaded"] = str(p)
        if args.delete_recording:
            await browser.delete(args.delete_recording)
            out["deleted"] = args.delete_recording
        if args.recordings:
            out["recordings"] = await browser.list_recordings()
        if args.recordings_url:
            out["recordings_url"] = await browser.folder_url()

    print(json.dumps(out))
    return 0


async def run(args) -> int:
    prefs = Preferences(args.prefs)
    transport = WebsocketTransport(args.url)
    client = CompanionClient(transport, prefs)
    try:
        documents = (
            iter_documents(Path(args.personalize_dir))
            if args.personalize_dir
            else None
        )
        try:
            key = await client.sign_in(
                args.token,
                server_auth_code=args.auth_code,
                email=args.email,
                documents=documents,
            )
        except AuthenticationError as e:
            print(f"sign-in rejected: {e}", file=sys.stderr)
            return 1
        status = {
            "signed_in": True,
            "access_key": key[:8] + "...",
            "display_name": await client.get_display_name(),
            "ble_id": await client.get_ble_id(),
            "device_online": await is_online(prefs),
            "blind_support": prefs.get_bool("blind_support"),
        }
        if args.blind is not None:
            await client.set_blind_support(args.blind == "on")
            status["blind_support"] = args.blind == "on"
        if args.say:
            reply = await client.request("send_data", (args.say,))
            status["reply"] = reply
        print(json.dumps(status))
        return 0
    finally:
        await transport.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", default="ws://127.0.0.1:4040")
    ap.add_argument("--token", default=None, help="id token for sign-in")
    ap.add_argument("--auth-code", default="", help="server auth code")
    ap.add_argument("--email", default="")
    ap.add_argument(
        "--personalize-dir",
        default=None,
        help="directory of .txt documents for the first-login upload",
    )
    ap.add_argument("--prefs", default=str(Path.home() / ".ist_companion.json"))
    ap.add_argument("--blind", choices=("on", "off"), default=None)
    ap.add_argument("--say", default=None, help="send one message and print the reply")
    # device-page surfaces (local; no server connection needed)
    ap.add_argument("--drive-dir",
                    default=str(Path.home() / ".ist_recordings"),
                    help="filesystem Drive twin for the recordings browser")
    ap.add_argument("--recordings", action="store_true",
                    help="list recordings in the media folder")
    ap.add_argument("--recordings-url", action="store_true",
                    help="print the media folder URL (device.dart:116)")
    ap.add_argument("--save-recording", default=None, metavar="FILE")
    ap.add_argument("--download-recording", default=None, metavar="ID")
    ap.add_argument("--dest", default=None)
    ap.add_argument("--delete-recording", default=None, metavar="ID")
    ap.add_argument("--settings", action="store_true",
                    help="dump the persisted settings store")
    ap.add_argument("--settings-set", action="append", metavar="KEY=VALUE")
    ap.add_argument("--wifi", default=None, metavar="SSID:PASSWORD",
                    help="print the WIFI: provisioning QR payload")
    args = ap.parse_args(argv)
    if args.token is None:
        local_ops = (
            args.recordings or args.recordings_url or args.save_recording
            or args.download_recording or args.delete_recording
            or args.settings or args.settings_set or args.wifi
        )
        if not local_ops:
            ap.error("--token is required unless using the local "
                     "recordings/settings/--wifi surfaces")
        return asyncio.run(run_local(args))
    return asyncio.run(run(args))


if __name__ == "__main__":
    raise SystemExit(main())
