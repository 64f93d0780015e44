"""ctypes bindings to the acquisition-firmware twin (``device_native/``).

C ABI surface (device_native/src/c_api.cpp): create/free, bring_up,
feed (inject analog microvolts), pump (run conversions), drain, and the
wire-frame builders for the device protocol (``eeg|key|payload``,
``eeg_end|key|``, BLE-side status strings).

A copy of ``imagined_speech_translation_tpu.device.native`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's, apart from where the library is found and how it is
built.  The port compiles ``libistdevice.so`` itself, as
``device_native/CMakeLists.txt`` does (C++17, ``-O2``, the three sources of
``device_native/src`` with ``device_native/include``), with the host C++
compiler (``$CXX``, else ``c++``) and neither cmake nor ninja, into
``<repo>/build/native/``.  It builds on first use, or when a source or
header is newer than the library, under a file lock, so concurrent
processes build it once; a failed build raises with the compiler's stderr.
It never reads or writes ``device_native/build/``, the CMake build the JAX
package uses.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shlex
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "device_native"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
_LIBRARY = _BUILD_DIR / "libistdevice.so"
_SOURCES = ("ads1299.cpp", "firmware.cpp", "c_api.cpp")

N_CHANNELS = 48  # 6 AFEs x 8 channels (device_native/include/device/firmware.h)


def _newest_input() -> float:
    inputs = [_NATIVE_DIR / "src" / s for s in _SOURCES]
    inputs += (_NATIVE_DIR / "include").rglob("*.h")
    return max(p.stat().st_mtime for p in inputs)


def find_native_library() -> Path | None:
    """The port's ``libistdevice.so``, if it is built and no source or header
    is newer."""
    if _LIBRARY.exists() and _LIBRARY.stat().st_mtime >= _newest_input():
        return _LIBRARY
    return None


def build_native_library() -> Path:
    """Compile ``build/native/libistdevice.so`` from ``device_native/src``
    (see the module docstring); returns its path."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "libistdevice.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if find_native_library() is not None:  # another process built it
            return _LIBRARY
        partial = _BUILD_DIR / f".libistdevice.{os.getpid()}.so"
        cmd = [*shlex.split(os.environ.get("CXX") or "c++"), "-std=c++17", "-O2",
               "-shared", "-fPIC", f"-I{_NATIVE_DIR / 'include'}",
               *(str(_NATIVE_DIR / "src" / s) for s in _SOURCES), "-o", str(partial)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"building {_LIBRARY.name} failed: {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(partial, _LIBRARY)
    return _LIBRARY


def _load(lib_path: Path | None = None) -> ctypes.CDLL:
    path = lib_path or find_native_library()
    if path is None:
        path = build_native_library()
    lib = ctypes.CDLL(str(path))
    c_ll = ctypes.c_longlong
    fp = ctypes.POINTER(ctypes.c_float)
    lib.device_create.restype = ctypes.c_void_p
    lib.device_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_double,
    ]
    lib.device_free.argtypes = [ctypes.c_void_p]
    lib.device_bring_up.restype = ctypes.c_int
    lib.device_bring_up.argtypes = [ctypes.c_void_p]
    lib.device_num_channels.restype = ctypes.c_int
    lib.device_data_rate.restype = ctypes.c_int
    lib.device_data_rate.argtypes = [ctypes.c_void_p]
    lib.device_feed.argtypes = [ctypes.c_void_p, fp, c_ll]
    lib.device_pump.restype = c_ll
    lib.device_pump.argtypes = [ctypes.c_void_p, c_ll]
    lib.device_queued.restype = c_ll
    lib.device_queued.argtypes = [ctypes.c_void_p]
    lib.device_drain.restype = c_ll
    lib.device_drain.argtypes = [ctypes.c_void_p, fp, c_ll]
    lib.device_wire_frame.restype = c_ll
    lib.device_wire_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, c_ll,
        ctypes.POINTER(ctypes.c_ubyte), c_ll,
    ]
    lib.device_end_frame.restype = c_ll
    lib.device_end_frame.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), c_ll,
    ]
    lib.device_status_frame.restype = ctypes.c_int
    lib.device_status_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, c_ll,
    ]
    return lib


class NativeBoard:
    """Python handle on the 6x-ADS1299 firmware twin."""

    def __init__(
        self,
        *,
        data_rate_sps: int = 500,
        gain: int = 24,
        noise_seed: int = 0,
        noise_uv: float = 0.0,
        lib_path: Path | None = None,
    ):
        self._lib = _load(lib_path)
        self._h = self._lib.device_create(
            data_rate_sps, gain, noise_seed, noise_uv
        )
        if not self._h:
            raise RuntimeError("device_create failed")

    def close(self) -> None:
        if self._h:
            self._lib.device_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def bring_up(self) -> None:
        """RESET -> SDATAC -> configure -> START -> RDATAC with register
        readback verification on all six AFEs."""
        if self._lib.device_bring_up(self._h) != 0:
            raise RuntimeError("AFE bring-up readback verification failed")

    @property
    def n_channels(self) -> int:
        return int(self._lib.device_num_channels())

    @property
    def data_rate_sps(self) -> int:
        return int(self._lib.device_data_rate(self._h))

    def feed(self, microvolts: np.ndarray) -> None:
        """Inject analog samples, shape ``(48, n)`` microvolts."""
        arr = np.ascontiguousarray(microvolts, np.float32)
        if arr.ndim != 2 or arr.shape[0] != N_CHANNELS:
            raise ValueError(f"expected (48, n), got {arr.shape}")
        self._lib.device_feed(
            self._h,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            arr.shape[1],
        )

    def pump(self, n_samples: int) -> int:
        """Run conversion ticks (ADC quantization happens here)."""
        return int(self._lib.device_pump(self._h, n_samples))

    @property
    def queued(self) -> int:
        return int(self._lib.device_queued(self._h))

    def drain(self, n_samples: int) -> np.ndarray:
        out = np.empty((N_CHANNELS, n_samples), np.float32)
        got = self._lib.device_drain(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_samples,
        )
        return out[:, : int(got)]

    # -- wire protocol ---------------------------------------------------
    def wire_frame(self, auth_key: str, n_samples: int) -> bytes:
        cap = len(auth_key) + 16 + 4 * N_CHANNELS * n_samples
        buf = (ctypes.c_ubyte * cap)()
        n = self._lib.device_wire_frame(
            self._h, auth_key.encode(), n_samples, buf, cap
        )
        if n < 0:
            raise RuntimeError(f"buffer too small, need {-n}")
        return bytes(buf[: int(n)])

    def end_frame(self, auth_key: str) -> bytes:
        cap = len(auth_key) + 16
        buf = (ctypes.c_ubyte * cap)()
        n = self._lib.device_end_frame(auth_key.encode(), buf, cap)
        return bytes(buf[: int(n)])

    def status_frame(self, kind: str, auth_key: str, arg: str) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.device_status_frame(
            kind.encode(), auth_key.encode(), str(arg).encode(), buf, 256
        )
        if n < 0:
            raise ValueError(f"unknown status kind {kind!r}")
        return buf.value.decode()
