"""Wire protocol framing.

Two framings from the reference:

* text frames ``command¬access_key¬arg1¬arg2...`` split on ``¬``
  (``wss/wss.js:33-35``) — control-plane commands;
* binary frames ``command|auth_key|payload`` where payload is raw bytes and
  only the first two ``|`` delimit (``dart_wss/lib/dart_wss.dart:133-148``)
  — device byte streams (audio, EEG windows).

A copy of ``imagined_speech_translation_tpu.runtime.protocol`` (the port
imports nothing of the JAX package); ``tests/test_torch_runtime.py``
holds the copy to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

DELIM = "¬"
BDELIM = b"|"


@dataclass(frozen=True)
class TextFrame:
    command: str
    access_key: str = ""
    args: tuple[str, ...] = ()


@dataclass(frozen=True)
class BinaryFrame:
    command: str
    auth_key: str
    payload: bytes = b""


def encode_text_frame(frame: TextFrame) -> str:
    parts = [frame.command]
    if frame.access_key or frame.args:
        parts.append(frame.access_key)
    parts.extend(frame.args)
    return DELIM.join(parts)


def decode_text_frame(message: str) -> TextFrame:
    parts = message.split(DELIM)
    if not parts or not parts[0]:
        raise ValueError("empty command frame")
    return TextFrame(
        command=parts[0],
        access_key=parts[1] if len(parts) > 1 else "",
        args=tuple(parts[2:]),
    )


def encode_binary_frame(frame: BinaryFrame) -> bytes:
    if BDELIM in frame.command.encode() or BDELIM in frame.auth_key.encode():
        raise ValueError("command/auth_key must not contain '|'")
    return (
        frame.command.encode() + BDELIM + frame.auth_key.encode() + BDELIM
        + frame.payload
    )


def decode_binary_frame(data: bytes) -> BinaryFrame:
    first = data.find(BDELIM)
    if first < 0:
        raise ValueError("missing command delimiter")
    second = data.find(BDELIM, first + 1)
    if second < 0:
        raise ValueError("missing auth delimiter")
    return BinaryFrame(
        command=data[:first].decode(),
        auth_key=data[first + 1 : second].decode(),
        payload=data[second + 1 :],
    )
