"""Full product journey, one process, printed as a transcript.

Port of ``examples/product_journey_demo.py``.  The reference user story end
to end (SURVEY.md §3.5 + ``app/lib``): sign-in with first-login
personalization -> BLE pairing -> device state push -> WiFi provisioning
(settings page credentials over BLE + the QR payload) -> imagined speech:
EEG frames through the REAL preprocess -> encode -> beam-decode pipeline on
``--device`` (the card by default; a tiny model with random weights from
seed 0, or ``state_dict``) -> decoded text back to the companion -> a
capture saved to the Drive-backed recordings folder, then browsed and
downloaded -> settings persisted -> sign-out.

    python -m imagined_speech_translation_tpu_torch.examples.product_journey_demo \\
        [--device cpu] [--transcript PATH] [--workdir DIR]

The working files (preferences, the recordings folder) go under
``--workdir`` (default: a fresh directory under ``build/``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
LINES: list[str] = []
VOCAB = list(dict.fromkeys(
    ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "[EOS]"]
    + list("我想喝水请帮打开窗户今天气很好")
))


def say(actor: str, msg: str) -> None:
    line = f"[{time.strftime('%H:%M:%S')}] {actor:>10} | {msg}"
    LINES.append(line)
    print(line, flush=True)


def demo_tokenizer():
    from ..data import ChineseCharTokenizer

    return ChineseCharTokenizer(VOCAB, eos_token="[EOS]")


def demo_config(tok, window: int):
    """The JAX demo's tiny config: hidden 48, 2 + 2 BART layers, beam 2 to
    length 8."""
    from ..config import (
        AugmentationConfig,
        BartConfig,
        BrainEncoderConfig,
        Config,
        DataConfig,
        GenerationConfig,
        ModelConfig,
        RegionEncoderConfig,
    )

    h = 48
    return Config(
        data=DataConfig(
            n_timepoints=window, max_length=8,
            augmentation=AugmentationConfig(enabled=False),
        ),
        model=ModelConfig(
            hidden_dim=h, max_region_channels=16,
            region_channel_counts=(16, 9, 11, 12),
            brain_encoder=BrainEncoderConfig(
                hidden_dim=h, fusion_heads=4, cross_region_heads=4,
                region_encoder=RegionEncoderConfig(
                    conv_channels=(8, 16, 24, 32, 48),
                    attn_heads=(4, 2, 2), se_reduction=4,
                ),
            ),
            bart=BartConfig(
                vocab_size=tok.vocab_size, d_model=h, encoder_layers=2,
                decoder_layers=2, num_heads=4, ffn_dim=96,
                max_position_embeddings=32,
                pad_token_id=tok.pad_token_id,
                bos_token_id=tok.bos_token_id,
                eos_token_id=tok.eos_token_id,
                decoder_start_token_id=tok.bos_token_id,
            ),
        ),
        generation=GenerationConfig(max_length=8, min_length=2, num_beams=2),
    ).validate()


def demo_spec(n_ch: int):
    from ..data import RegionSpec
    from ..data.synthetic import make_synthetic_montage

    with tempfile.TemporaryDirectory() as d:
        labels = make_synthetic_montage(Path(d) / "m.csv", n_channels=n_ch)
    return RegionSpec.from_channel_names(labels)


def build_tiny_decode_fn(n_ch: int, window: int, *, device: str = "cuda", state_dict=None,
                         fold_bn: bool = True):
    """The real preprocess -> encode -> beam-decode function on the tiny
    model (float32): random weights from seed 0, or ``state_dict`` loaded
    strictly."""
    import torch

    from ..cli.serve import build_decode_fn
    from ..models import build_model

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run the demo on the CPU")
    tok = demo_tokenizer()
    cfg = demo_config(tok, window)
    model = build_model(cfg.model, window, seed=0, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return build_decode_fn(cfg, tok, demo_spec(n_ch), model, device=device, fold_bn=fold_bn)


async def journey(args, *, state_dict=None, fold_bn: bool = True) -> dict:
    from ..companion import (
        CompanionClient,
        Contact,
        InMemoryBle,
        InMemoryPhone,
        InProcessTransport,
        LocalDirDrive,
        PhoneActions,
        Preferences,
        RecordingsBrowser,
        SettingsPanel,
        is_online,
    )
    from ..companion.ble import pair
    from ..runtime import DecodePipeline, RingBuffer, SessionRegistry, Windower
    from ..runtime.commands import build_command_registry
    from ..runtime.personalization import parse_wifi_qr, wifi_qr_payload
    from ..runtime.server import WssService
    from ..runtime.services import ServiceBundle

    n_ch, window = 125, args.window

    say("demo", f"building the decode pipeline on {args.device} (tiny model)...")
    decode_fn = build_tiny_decode_fn(n_ch, window, device=args.device, state_dict=state_dict,
                                     fold_bn=fold_bn)

    bundle = ServiceBundle()
    registry = build_command_registry(bundle, registry=SessionRegistry())
    svc = WssService(
        registry, services=bundle,
        pipeline_factory=lambda key: DecodePipeline(
            windower=Windower(RingBuffer(n_ch, 8 * window), window=window, hop=window),
            decode_fn=decode_fn, max_batch=4,
        ),
        n_channels=n_ch,
    )

    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(
        prefix="ist_journey_", dir=_build_dir()))
    workdir.mkdir(parents=True, exist_ok=True)
    prefs = Preferences(workdir / "prefs.json")
    link_box: dict = {}

    async def device_write(frame: str):
        await link_box["link"].write_data(frame)

    client = CompanionClient(InProcessTransport(svc), prefs, device_write=device_write)

    # -- 1. sign in (first login uploads the personalization corpus) ------
    docs = [f"note {i}: the user likes tea 用户喜欢喝茶" for i in range(60)]
    key = await client.sign_in(
        "demo-google-id-token", server_auth_code="sac-demo",
        email="ada@example.com", documents=docs,
    )
    say("companion", f"signed in; access key {key[:8]}… ; uploaded "
        f"{len(docs)} personalization documents in batches of 50")

    # -- 2. pair the glasses over BLE --------------------------------------
    await client.set_ble_id("GLASSES-DEMO")
    radio = InMemoryBle(devices={"GLASSES-DEMO": object()})
    link = await pair(radio, ble_id="GLASSES-DEMO", auth_key=key, prefs=prefs)
    assert link is not None and link.connected
    link.phone = PhoneActions(
        InMemoryPhone(contacts=(Contact("Ada", ("+44 20 7946 0000",)),)),
        auth_key=key, write_data=link.write_data,
    )
    link_box["link"] = link
    say("companion", "paired with GLASSES-DEMO over BLE")

    await radio.emit_notify(f"ip|{key}|192.168.1.77".encode())
    await radio.emit_notify(f"battery|{key}|83".encode())
    say("glasses", "pushed state: ip=192.168.1.77 battery=83%")

    # -- 3. provision WiFi: settings page creds over BLE + the QR payload --
    panel = SettingsPanel(client)
    info = await panel.user_info()
    say("settings", f"user: {info['display_name']} <{info['email']}> ; "
        f"device: {panel.device_info()['model']}")
    await panel.connect_wifi("HomeNet", "hunter2")
    say("settings", f"sent over BLE: {radio.written[-1].decode()!r}")
    qr = wifi_qr_payload("HomeNet", "hunter2")
    assert parse_wifi_qr(qr)["ssid"] == "HomeNet"
    say("settings", f"QR fallback payload renders: {qr}")

    async def ok_get(url, timeout):
        say("wifi", f"liveness probe {url} -> 200")
        return 200

    assert await is_online(prefs, http_get=ok_get)

    # -- 4. speak: EEG frames through the real decode pipeline -------------
    rng = np.random.default_rng(7)
    eeg = rng.normal(size=(n_ch, 2 * window)).astype(np.float32)
    say("glasses", f"streaming EEG: {eeg.shape[0]} channels x {eeg.shape[1]} samples")
    t0 = time.perf_counter()
    texts = await svc.handle_binary(b"eeg|" + key.encode() + b"|" + eeg.tobytes())
    texts += await svc.handle_binary(b"eeg_end|" + key.encode() + b"|")
    dt = time.perf_counter() - t0
    for t in texts:
        say("decoder", f"utterance: {t!r}")
    say("decoder", f"{len(texts)} windows decoded in {dt:.2f}s")

    # -- 5. the capture lands in the recordings folder; browse it ----------
    browser = RecordingsBrowser(LocalDirDrive(workdir / "drive"))
    clip = b"RIFFAVI-DEMO" + eeg[:2, :16].tobytes()
    meta = await browser.save_recording("capture_0001.avi", clip)
    say("device", f"saved recording {meta['name']} ({meta['size']} bytes) "
        f"to '{browser.folder_name}'")
    listing = await browser.list_recordings()
    say("companion", "recordings: " + json.dumps(
        [{"name": f["name"], "size": f["size"]} for f in listing]))
    say("companion", f"folder url: {await browser.folder_url()}")
    dest = await browser.download_to(meta["id"], workdir / "download.avi")
    assert dest.read_bytes() == clip
    say("companion", f"downloaded {meta['name']} -> {dest}")

    # -- 6. settings get/set persist; sign out ------------------------------
    panel.set("volume", 6)
    say("settings", f"persisted store: {json.dumps(panel.all())}")
    panel.sign_out()
    say("companion", "signed out (logged=false)")

    return {"utterances": texts, "recordings": len(listing), "workdir": str(workdir)}


def _build_dir() -> Path:
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    return build


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--transcript", default=None)
    return ap.parse_args(argv)


def main(argv=None, *, state_dict=None, fold_bn: bool = True) -> int:
    from ..utils.cache import enable_persistent_cache

    args = parse_args(argv)
    enable_persistent_cache()
    result = asyncio.run(journey(args, state_dict=state_dict, fold_bn=fold_bn))
    say("demo", f"journey complete: {json.dumps(result)}")
    if args.transcript:
        Path(args.transcript).write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
