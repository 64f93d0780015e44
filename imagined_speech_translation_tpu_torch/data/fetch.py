"""Chisco corpus fetcher (reference: ``main_model/data/dataset.sh``).

A copy of ``imagined_speech_translation_tpu.data.fetch`` (jax-free), so the
port's ``cli.reproduce`` imports nothing of the JAX package; a test holds
its code to the original's.

The reference ships 224 hardcoded ``curl`` commands against pinned S3
object versions of OpenNeuro **ds005170** (subjects 01–05, preprocessed
imagined-speech pickles).  This is the tool-shaped equivalent: it LISTS the
public bucket prefix via the S3 REST API (no credentials), filters to the
``*_task-imagine_*_eeg.pkl`` derivatives the training pipeline consumes
(``data/chisco.py``), and downloads with skip-of-complete-files + size
verification + a manifest, so the corpus definition tracks the dataset
rather than a frozen URL snapshot.  Downloads stream in 1 MiB chunks to a
``.part`` temp file (renamed into place on success — the real ds005170
pickles are hundreds of MB and must not be buffered whole), resume
interrupted ``.part`` files via HTTP ``Range``, and retry transient
failures with backoff.

Network-free by construction for tests: the HTTP transport is injectable
(``http(method, url) -> (status, bytes)`` for listing and
``http_stream(url, offset) -> (status, chunk_iterator)`` for downloads);
the CLI wires ``urllib``.

Usage::

    python -m imagined_speech_translation_tpu_torch.data.fetch --out data/chisco \\
        [--subjects 01 02]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Callable, Iterable, Iterator, Tuple

HttpFn = Callable[[str, str], Tuple[int, bytes]]
# (url, byte_offset) -> (status, chunk iterator); status 206 = partial
# content from `offset`, 200 = full body from byte 0
StreamFn = Callable[[str, int], Tuple[int, Iterable[bytes]]]

CHUNK = 1 << 20
RETRIES = 3

BUCKET = "https://s3.amazonaws.com/openneuro.org"
DATASET = "ds005170"
PREFIX = f"{DATASET}/derivatives/preprocessed_pkl"
SUBJECTS = ("01", "02", "03", "04", "05")
_S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _urllib_http(method: str, url: str) -> Tuple[int, bytes]:
    import urllib.request

    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:  # pragma: no cover - network path
        return e.code, e.read()


def _urllib_stream(
    url: str, offset: int
) -> Tuple[int, Iterator[bytes]]:  # pragma: no cover - network path
    import urllib.request

    headers = {"Range": f"bytes={offset}-"} if offset > 0 else {}
    req = urllib.request.Request(url, headers=headers)
    try:
        resp = urllib.request.urlopen(req, timeout=120)
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, iter(())

    def chunks(r=resp):
        try:
            while True:
                b = r.read(CHUNK)
                if not b:
                    return
                yield b
        finally:
            r.close()

    return resp.status, chunks()


def download_file(
    url: str,
    dest: Path,
    expected_size: int,
    *,
    stream: StreamFn = _urllib_stream,
    retries: int = RETRIES,
    log=print,
) -> None:
    """Stream ``url`` into ``dest`` via a ``dest.part`` temp file.

    An existing ``.part`` resumes from its current length with an HTTP
    ``Range`` request (S3 honors Range; a 200 answer restarts from byte 0).
    Transient failures retry with linear backoff, re-resuming from whatever
    the ``.part`` already holds — so an interrupted multi-hundred-MB pickle
    never restarts from scratch (reference fetch: one non-resumable curl
    per file, ``main_model/data/dataset.sh``)."""
    part = dest.with_suffix(dest.suffix + ".part")
    last_err: Exception | None = None
    for attempt in range(retries):
        offset = part.stat().st_size if part.exists() else 0
        if offset > expected_size:
            part.unlink()  # corrupt leftover, restart clean
            offset = 0
        elif offset == expected_size:
            # interrupted between the final write and the rename: the
            # .part is already complete — a Range request from EOF would
            # 416 forever, so just finish the rename
            part.rename(dest)
            return
        try:
            status, chunks = stream(url, offset)
            if status == 200 and offset > 0:
                offset = 0  # server ignored Range: full body follows
            if status not in (200, 206):
                raise RuntimeError(f"download failed ({status}): {url}")
            mode = "ab" if offset > 0 else "wb"
            with open(part, mode) as fh:
                for chunk in chunks:
                    fh.write(chunk)
            got = part.stat().st_size
            if got != expected_size:
                raise RuntimeError(
                    f"size mismatch for {dest.name}: got {got}, "
                    f"expected {expected_size}"
                )
            part.rename(dest)
            return
        except Exception as e:  # noqa: BLE001 - retried, re-raised below
            last_err = e
            if attempt < retries - 1:
                log(f"  retry {attempt + 1}/{retries - 1} for {dest.name}: {e}")
                time.sleep(attempt + 1)
    raise RuntimeError(f"download failed after {retries} tries: {last_err}")


def list_subject_files(
    subject: str, http: HttpFn = _urllib_http
) -> list[dict]:
    """List ``sub-<N>`` imagine-task pickles via the public S3 list API
    (paginated ``list-type=2``); returns [{key, size}]."""
    out: list[dict] = []
    token = None
    prefix = f"{PREFIX}/sub-{subject}/eeg/"
    while True:
        url = f"{BUCKET}/?list-type=2&prefix={prefix}"
        if token:
            from urllib.parse import quote

            url += f"&continuation-token={quote(token)}"
        status, body = http("GET", url)
        if status != 200:
            raise RuntimeError(f"S3 list failed ({status}) for {prefix}")
        root = ET.fromstring(body)
        for item in root.iter(f"{_S3_NS}Contents"):
            key = item.find(f"{_S3_NS}Key").text
            size = int(item.find(f"{_S3_NS}Size").text)
            if "_task-imagine_" in key and key.endswith("_eeg.pkl"):
                out.append({"key": key, "size": size})
        trunc = root.find(f"{_S3_NS}IsTruncated")
        if trunc is None or trunc.text != "true":
            break
        token = root.find(f"{_S3_NS}NextContinuationToken").text
    return out


def _stream_from_http(http: HttpFn) -> StreamFn:
    """Adapt a buffered (method, url) transport into the streaming
    interface (tests inject these; resume slices the buffered body)."""

    def stream(url: str, offset: int) -> Tuple[int, Iterator[bytes]]:
        status, body = http("GET", url)
        if status != 200:
            return status, iter(())
        if offset > 0:
            return 206, iter([body[offset:]])
        return 200, iter([body])

    return stream


def fetch_corpus(
    out_dir: str | Path,
    *,
    subjects=SUBJECTS,
    http: HttpFn = _urllib_http,
    stream: StreamFn | None = None,
    retries: int = RETRIES,
    log=print,
) -> dict:
    """Download all subjects' pickles into ``out_dir`` (flat layout the
    dataset loader scans); files already present at the expected size are
    skipped; interrupted ``.part`` files resume via HTTP Range.
    Writes ``manifest.json`` and returns it."""
    if stream is None:
        stream = (
            _urllib_stream if http is _urllib_http else _stream_from_http(http)
        )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"dataset": DATASET, "files": []}
    for subject in subjects:
        files = list_subject_files(subject, http)
        log(f"sub-{subject}: {len(files)} imagine-task pickles")
        for f in files:
            name = f["key"].rsplit("/", 1)[-1]
            dest = out / name
            if dest.exists() and dest.stat().st_size == f["size"]:
                manifest["files"].append({**f, "name": name, "cached": True})
                continue
            download_file(
                f"{BUCKET}/{f['key']}", dest, f["size"],
                stream=stream, retries=retries, log=log,
            )
            manifest["files"].append({**f, "name": name, "cached": False})
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    log(f"{len(manifest['files'])} files in {out}")
    return manifest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--out", default="data/chisco")
    ap.add_argument("--subjects", nargs="*", default=list(SUBJECTS))
    args = ap.parse_args(argv)
    try:
        fetch_corpus(args.out, subjects=args.subjects)
    except Exception as e:
        print(f"fetch failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
