"""Builds and loads the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  On first use they are
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library under
``build/kernels/`` at the repository root (named by a hash of the sources, so
an edit rebuilds), and loaded with ``ctypes``.  Nothing here runs at import:
the CPU tests import every module on a machine without ``nvcc``.

Each :class:`Kernel` keeps a plain launch counter.  A wrapper calls
:meth:`Kernel.launch`, which calls the C entry point, raises if the launch
returned a CUDA error, and only then adds one to the count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("sosfilt.cu", "flash_fwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ist_sosfilt_f32": [_P, _P, _I, _I, _P, _I, _P],
    "ist_sosfilt_max_sections": [],
    "ist_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: compiler output and seconds of the build that produced the loaded library
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        paths = [CSRC / s for s in SOURCES]
        digest = hashlib.sha256()
        for p in paths:
            digest.update(p.read_bytes())
        so = BUILD_DIR / f"libist_kernels-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)],
                capture_output=True, text=True,
            )
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ist_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ist_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


class Kernel:
    """One CUDA kernel of the library: its C entry point and launch count."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args) -> None:
        lib = library()
        err = getattr(lib, self.entry)(*args)
        if err != 0:
            msg = lib.ist_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err} ({msg})")
        self.launches += 1


SOSFILT = Kernel(
    "sosfilt", "ist_sosfilt_f32",
    "imagined_speech_translation_tpu_torch/csrc/sosfilt.cu",
    "imagined_speech_translation_tpu/frontend/filters.py:108",
)
FLASH_FWD = Kernel(
    "flash_fwd", "ist_flash_fwd",
    "imagined_speech_translation_tpu_torch/csrc/flash_fwd.cu",
    "imagined_speech_translation_tpu/ops/pallas_attention.py:153",
)
KERNELS = (SOSFILT, FLASH_FWD)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
