"""Media assembly: camera frames + PCM audio → video file.

Reference: ``dart_wss/lib/video.dart:9-60`` writes frames as PPM files and
raw PCM, then muxes with ffmpeg (15 fps, s16le).  Same here, with a
pure-Python fallback (frames + .pcm left on disk) when ffmpeg is absent.

A copy of ``imagined_speech_translation_tpu.runtime.media`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np


def write_ppm(path: str | Path, frame: np.ndarray) -> None:
    """``(H, W, 3)`` uint8 → binary PPM (P6)."""
    frame = np.asarray(frame, np.uint8)
    h, w, c = frame.shape
    if c != 3:
        raise ValueError("expected RGB frame")
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(frame.tobytes())


class VideoAssembler:
    """Collects frames/PCM; ``mux`` produces an mp4 via ffmpeg (15 fps,
    s16le mono audio — reference settings) or leaves raw parts otherwise."""

    def __init__(self, *, fps: int = 15, sample_rate: int = 24000):
        self.fps = fps
        self.sample_rate = sample_rate
        self.frames: list[np.ndarray] = []
        self.pcm = bytearray()

    def add_frame(self, frame: np.ndarray) -> None:
        self.frames.append(np.asarray(frame, np.uint8))

    def add_audio(self, pcm: bytes) -> None:
        self.pcm.extend(pcm)

    @staticmethod
    def ffmpeg_available() -> bool:
        return shutil.which("ffmpeg") is not None

    def mux(self, out_path: str | Path) -> Path:
        out_path = Path(out_path)
        work = Path(tempfile.mkdtemp(prefix="wake_video_"))
        for i, frame in enumerate(self.frames):
            write_ppm(work / f"frame_{i:06d}.ppm", frame)
        audio = work / "audio.pcm"
        audio.write_bytes(bytes(self.pcm))
        if not self.ffmpeg_available():
            # fallback: deliver the raw parts directory
            fallback = out_path.with_suffix(".raw")
            if fallback.exists():
                shutil.rmtree(fallback)
            shutil.move(work, fallback)
            return fallback
        cmd = [
            "ffmpeg", "-y",
            "-framerate", str(self.fps),
            "-i", str(work / "frame_%06d.ppm"),
        ]
        if self.pcm:
            cmd += [
                "-f", "s16le", "-ar", str(self.sample_rate), "-ac", "1",
                "-i", str(audio),
            ]
        cmd += ["-pix_fmt", "yuv420p", str(out_path)]
        subprocess.run(cmd, check=True, capture_output=True)
        shutil.rmtree(work, ignore_errors=True)
        return out_path
