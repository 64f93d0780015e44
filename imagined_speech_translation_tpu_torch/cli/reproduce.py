"""``reproduce`` — one-command real-artifact reproduction, in the port.

Port of ``imagined_speech_translation_tpu.cli.reproduce``: the same plan,
flags and structured outcomes, chaining the port's own tools:

1. probe egress (OpenNeuro S3 + huggingface.co, bounded timeouts);
2. fetch the Chisco imagine-task pickles (``data/fetch.py``, resumable);
3. snapshot ``fnlp/bart-base-chinese`` (weights + vocab);
4. convert the HF checkpoint into the port's BART decoder weights
   (``cli.convert_hf``: one ``torch.save`` file, ``bart_params.pt``);
5. decode-parity report: greedy + beam-3 token identity of the port's
   ``build_bart_generate_fn`` on ``--device`` vs HF ``generate``, written to
   ``<work-dir>/parity_report.json``; identity must be 1.0;
6. optionally (``--train``) the reference-shaped fine-tune, ``cli.train
   --bart-params``.

With no egress and a fetch still needed it fails fast and structured: one
JSON line ``{"status": "blocked", "reason": "no-egress", ...}``, exit code
3, never a stack trace.  ``--dry-run`` validates the plan offline (imports,
entry points, disk) and exits 0.  The chain runs on the card unless
``--device cpu`` is given::

    python -m imagined_speech_translation_tpu_torch.cli.reproduce \\
        [--work-dir runs/reproduce] [--data-dir <pickles>] \\
        [--hf-checkpoint <HF dir>] [--train] [--dry-run] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
import urllib.request
from pathlib import Path

HF_REPO = "fnlp/bart-base-chinese"
PROBE_URLS = (
    # the fetcher's S3 list endpoint (data/fetch.py) and the HF hub
    "https://s3.amazonaws.com/openneuro.org?list-type=2&max-keys=1&prefix=ds005170/",
    "https://huggingface.co/api/models/fnlp/bart-base-chinese",
)
BLOCKED_EXIT = 3
PARAMS_FILE = "bart_params.pt"


def _probe_url(url: str, timeout: float = 8.0) -> dict:
    t0 = time.monotonic()
    try:
        req = urllib.request.Request(url, method="GET")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return {"url": url, "ok": True, "status": r.status,
                    "elapsed_s": round(time.monotonic() - t0, 2)}
    except Exception as e:  # noqa: BLE001 — any transport failure = no egress
        return {"url": url, "ok": False, "error": str(e)[:200],
                "elapsed_s": round(time.monotonic() - t0, 2)}


def probe_egress(urls=PROBE_URLS) -> list[dict]:
    return [_probe_url(u) for u in urls]


def _have_pickles(d: Path) -> bool:
    return d.is_dir() and any(d.glob("*_task-imagine_*.pkl"))


def _have_hf_checkpoint(d: Path) -> bool:
    return d.is_dir() and (
        (d / "model.safetensors").exists() or (d / "pytorch_model.bin").exists()
    )


def build_plan(args) -> list[dict]:
    """The JAX plan, step for step; the converted weights are one file."""
    work = Path(args.work_dir)
    data_dir = Path(args.data_dir) if args.data_dir else work / "chisco"
    hf_dir = Path(args.hf_checkpoint) if args.hf_checkpoint else work / "hf"
    plan = [
        {"step": "fetch-chisco", "dest": str(data_dir),
         "skipped": _have_pickles(data_dir)},
        {"step": "fetch-hf", "repo": HF_REPO, "dest": str(hf_dir),
         "skipped": _have_hf_checkpoint(hf_dir)},
        {"step": "convert-hf", "out": str(work / PARAMS_FILE),
         "skipped": (work / PARAMS_FILE).is_file()},
        {"step": "parity-report", "out": str(work / "parity_report.json"),
         "skipped": False},
    ]
    if args.train:
        plan.append({"step": "train", "out": str(work / "train"),
                     "skipped": False})
    return plan


def check_tools() -> dict:
    """Offline sanity: every import and entry point the plan needs."""
    checks = {}
    for mod in ("torch", "transformers", "numpy"):
        try:
            __import__(mod)
            checks[mod] = True
        except ImportError:
            checks[mod] = False
    from . import convert_hf, train  # noqa: F401 — resolvable entry points
    from ..data import fetch  # noqa: F401
    from ..models import hf_convert  # noqa: F401

    checks["entry_points"] = True
    checks["free_disk_gb"] = round(shutil.disk_usage(".").free / 1e9, 1)
    return checks


def fetch_hf_snapshot(dest: Path, log=print) -> None:
    """Materialize the HF checkpoint + vocab into ``dest`` (reference model:
    bart_decoder.py:20; tokenizer: BertTokenizer over the same repo)."""
    import transformers

    dest.mkdir(parents=True, exist_ok=True)
    log(f"downloading {HF_REPO} ...")
    model = transformers.BartForConditionalGeneration.from_pretrained(HF_REPO)
    tok = transformers.BertTokenizer.from_pretrained(HF_REPO)
    model.save_pretrained(dest)
    tok.save_vocabulary(str(dest))
    log(f"saved to {dest}")


def parity_report(hf_dir: Path, params_path: Path, out_path: Path, n_cases: int = 6,
                  device="cuda", log=print) -> dict:
    """Greedy + beam-3 token identity of the port's decoder, loaded from the
    converted ``params_path`` on ``device``, against HF ``generate`` on the
    CPU, both on the same weights.

    Conditioning follows the reference scheme exactly: decode against
    pseudo-encoder states (bart_decoder.py:29-48), case ``i``'s drawn from
    ``default_rng(i)``, B = 2, S = 3, length 16, min 3, greedy on even
    cases and beam 3 on odd ones.  Identity must be 1.0; the report records
    per-case mismatch positions otherwise."""
    import numpy as np
    import torch
    import transformers
    from transformers.modeling_outputs import BaseModelOutput

    from ..config import BartConfig
    from ..decode import DecodeParams, build_bart_generate_fn
    from ..models import BartDecoderModel

    device = torch.device(device)
    hf = transformers.BartForConditionalGeneration.from_pretrained(hf_dir)
    hf.eval()
    c = hf.config
    cfg = BartConfig(
        vocab_size=c.vocab_size, d_model=c.d_model,
        encoder_layers=c.encoder_layers, decoder_layers=c.decoder_layers,
        num_heads=c.decoder_attention_heads, ffn_dim=c.decoder_ffn_dim,
        max_position_embeddings=c.max_position_embeddings,
        pad_token_id=c.pad_token_id, bos_token_id=c.bos_token_id,
        eos_token_id=c.eos_token_id,
        decoder_start_token_id=c.decoder_start_token_id,
    )
    model = BartDecoderModel(cfg)
    model.load_state_dict(torch.load(params_path, map_location="cpu", weights_only=True))
    model = model.to(device).eval()

    B, S = 2, 3
    report = {"repo": str(hf_dir), "cases": [], "identity": None}
    matches = 0
    for case in range(n_cases):
        rng = np.random.default_rng(case)
        enc = rng.normal(size=(B, S, c.d_model)).astype(np.float32)
        beams = 1 if case % 2 == 0 else 3
        with torch.no_grad():
            ref = hf.generate(
                encoder_outputs=BaseModelOutput(
                    last_hidden_state=torch.from_numpy(enc)
                ),
                attention_mask=torch.ones(B, S, dtype=torch.long),
                do_sample=False, max_length=16, min_length=3,
                num_beams=beams, early_stopping=beams > 1,
            ).numpy()
        dp = DecodeParams(
            max_length=16, min_length=3, num_beams=beams,
            early_stopping=beams > 1, pad_token_id=c.pad_token_id,
            eos_token_id=c.eos_token_id,
            decoder_start_token_id=c.decoder_start_token_id,
        )
        gen = build_bart_generate_fn(model, dp)
        got = gen(torch.from_numpy(enc).to(device)).cpu().numpy()
        padded = np.full_like(got, c.pad_token_id)
        padded[:, : ref.shape[1]] = ref[:, : got.shape[1]]
        same = bool(np.array_equal(got, padded))
        matches += same
        report["cases"].append({
            "seed": case, "num_beams": beams, "identical": same,
            "mismatches": [] if same else
            np.argwhere(got != padded).tolist(),
        })
        log(f"case {case} (beam {beams}): {'OK' if same else 'MISMATCH'}")
    report["identity"] = matches / n_cases
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--work-dir", default="runs/reproduce")
    ap.add_argument("--data-dir", default=None,
                    help="existing Chisco pickles (skips the download)")
    ap.add_argument("--hf-checkpoint", default=None,
                    help="existing fnlp/bart-base-chinese dir (skips the hub)")
    ap.add_argument("--train", action="store_true",
                    help="after parity, launch the reference-shaped fine-tune")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the plan offline and exit")
    ap.add_argument("--subjects", nargs="*", default=None,
                    help="restrict the Chisco fetch (e.g. 01 02)")
    ap.add_argument("--parity-cases", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    work = Path(args.work_dir)
    plan = build_plan(args)
    checks = check_tools()

    if args.dry_run:
        print(json.dumps({
            "status": "dry-run-ok", "plan": plan, "tools": checks,
            "note": "no network touched; run without --dry-run to execute",
        }))
        return 0

    from .train import check_device

    device = check_device(args.device)

    # ---- egress gate: every non-skipped network step needs it ----------
    need_net = any(
        not s["skipped"] for s in plan if s["step"].startswith("fetch")
    )
    if need_net:
        probes = probe_egress()
        if not any(p["ok"] for p in probes):
            print(json.dumps({
                "status": "blocked", "reason": "no-egress",
                "probes": probes, "plan": plan,
                "next": "re-run when the environment has network access; "
                        "or pass --data-dir/--hf-checkpoint for local "
                        "artifacts",
            }))
            return BLOCKED_EXIT

    work.mkdir(parents=True, exist_ok=True)
    data_dir = Path(args.data_dir) if args.data_dir else work / "chisco"
    hf_dir = Path(args.hf_checkpoint) if args.hf_checkpoint else work / "hf"

    if not _have_pickles(data_dir):
        from ..data.fetch import SUBJECTS, fetch_corpus

        fetch_corpus(data_dir,
                     subjects=tuple(args.subjects) if args.subjects
                     else SUBJECTS)
    if not _have_hf_checkpoint(hf_dir):
        fetch_hf_snapshot(hf_dir)

    params_path = work / PARAMS_FILE
    if not params_path.is_file():
        from .convert_hf import main as convert_main

        convert_main(["--checkpoint", str(hf_dir), "--out", str(params_path)])

    report = parity_report(hf_dir, params_path, work / "parity_report.json",
                           n_cases=args.parity_cases, device=device)
    if report["identity"] < 1.0:
        print(json.dumps({"status": "parity-failed", **report}))
        return 1

    if args.train:
        from .train import main as train_main

        train_main([
            "--data-dir", str(data_dir),
            "--montage", str(data_dir / "montage.csv"),
            "--vocab", str(hf_dir / "vocab.txt"),
            "--out-dir", str(work / "train"),
            "--bart-params", str(params_path),
            "--device", args.device,
        ])

    print(json.dumps({"status": "ok", "identity": report["identity"],
                      "report": str(work / "parity_report.json")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
