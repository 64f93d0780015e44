"""Builds and loads the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  On first use each is
compiled with ``nvcc`` for Hopper (``sm_90a``), all at once in parallel, and
linked into one shared library under ``build/kernels/`` at the repository
root (named by a hash of the sources and headers, so an edit rebuilds), and
loaded with ``ctypes``.  Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``.

Each :class:`Kernel` keeps a plain launch counter.  A wrapper calls
:meth:`Kernel.launch`, which calls the C entry point, raises if the launch
returned a CUDA error, and only then adds one to the count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("sosfilt.cu", "flash_fwd.cu", "flash_bwd.cu", "flash_bwd_split.cu", "dropout_mask.cu")
HEADERS = ("dropout_mask.cuh", "flash_bwd_kv.cuh", "flash_bwd_tf32.cuh", "sm90.cuh",
           "tf32.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ist_sosfilt_f32": [_P, _P, _I, _I, _P, _I, _P, _I, _P],
    "ist_sosfilt_max_sections": [],
    "ist_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                      _I, _I, ctypes.c_uint, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P],
    "ist_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                      ctypes.c_float, _I, _I, _I, ctypes.c_uint, _I, _I, ctypes.c_float,
                      _I, _I, _I, _I, _P],
    "ist_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                         ctypes.c_float, _I, _P],
    "ist_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float,
                          ctypes.c_float, _I, _P],
    "ist_dropout_mask": [_P, _I, _I, _I, _I, _I, _I, ctypes.c_uint, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: compiler output of the build that produced the loaded library (kept beside
#: it, so a later process that loads it reads the same), and that build's seconds
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


def _build(so: Path, tag: str) -> str:
    """Compile every source to an object file, one ``nvcc`` each, all
    started together, then link them into ``so``; returns the compiler
    output (``-Xptxas -v`` register and spill lines included)."""
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{Path(name).stem}{tag}.o" for name in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs = [f"--- {name}\n{p.communicate()[0]}" for name, p in zip(SOURCES, procs)]
    log = "".join(logs)
    failed = [name for name, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = so.with_suffix(f"{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for name in SOURCES + HEADERS:
            digest.update((CSRC / name).read_bytes())
        so = BUILD_DIR / f"libist_kernels-{digest.hexdigest()[:16]}.so"
        log_path = so.with_suffix(".log")
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _build(so, f".{os.getpid()}")
            build_seconds = time.perf_counter() - t0
            log_path.write_text(build_log)
        elif log_path.exists():
            build_log = log_path.read_text()
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ist_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ist_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def ptxas_info(fragment: str) -> dict[str, list[str]]:
    """``-Xptxas -v`` lines (registers, stack, spills) of each compiled entry
    function whose mangled name contains ``fragment``, from the build of the
    loaded library."""
    out: dict[str, list[str]] = {}
    entry = None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if fragment in m.group(1) else None
            if entry:
                out.setdefault(entry, [])
        elif entry and ("registers" in line or "spill" in line):
            out[entry].append(line.strip())
    return out


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
FLASH_BWD = Kernel(
    "flash_bwd", "ist_flash_bwd",
    "imagined_speech_translation_tpu_torch/csrc/flash_bwd.cu",
    "imagined_speech_translation_tpu/ops/pallas_attention.py:273",
)
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "ist_flash_bwd_dq",
    "imagined_speech_translation_tpu_torch/csrc/flash_bwd_split.cu",
    "imagined_speech_translation_tpu/ops/pallas_attention.py:408",
)
FLASH_BWD_DKV = Kernel(
    "flash_bwd_dkv", "ist_flash_bwd_dkv",
    "imagined_speech_translation_tpu_torch/csrc/flash_bwd_split.cu",
    "imagined_speech_translation_tpu/ops/pallas_attention.py:450",
)
DROPOUT_MASK = Kernel(
    "dropout_mask", "ist_dropout_mask",
    "imagined_speech_translation_tpu_torch/csrc/dropout_mask.cu",
    "tools/tpu_kernel_check.py:190",
)
KERNELS = (SOSFILT, FLASH_FWD, FLASH_BWD, FLASH_BWD_DQ, FLASH_BWD_DKV, DROPOUT_MASK)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
