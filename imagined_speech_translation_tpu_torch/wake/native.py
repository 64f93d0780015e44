"""ctypes bindings to the native wake-detector library (``wake_native/``).

A copy of ``imagined_speech_translation_tpu.wake.native`` (it imports no
jax), so the port imports nothing of the JAX package; a test holds its code
to the original's.  ``_REPO_ROOT`` is two levels above this package's
``wake/`` as it is above the JAX package's, so both find the same
``wake_native/``.  The shared library exposes a C ABI
(wake_native/src/c_api.cpp): create / forward / train_step / save / load.
``build_native_library`` drives the CMake build when the .so is absent
(cmake + ninja are expected on the host).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _REPO_ROOT / "wake_native"


def find_native_library() -> Path | None:
    for cand in (
        _NATIVE_DIR / "build" / "libwake.so",
        _NATIVE_DIR / "build" / "wake.dll",
    ):
        if cand.exists():
            return cand
    return None


def build_native_library(*, generator: str = "Ninja") -> Path:
    build = _NATIVE_DIR / "build"
    subprocess.run(
        ["cmake", "-S", str(_NATIVE_DIR), "-B", str(build), "-G", generator],
        check=True,
        capture_output=True,
    )
    subprocess.run(
        ["cmake", "--build", str(build)], check=True, capture_output=True
    )
    lib = find_native_library()
    if lib is None:
        raise RuntimeError("build succeeded but libwake.so not found")
    return lib


def _load(lib_path: Path | None = None) -> ctypes.CDLL:
    path = lib_path or find_native_library()
    if path is None:
        path = build_native_library()
    lib = ctypes.CDLL(str(path))
    lib.wake_create.restype = ctypes.c_void_p
    lib.wake_create.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint]
    lib.wake_free.argtypes = [ctypes.c_void_p]
    lib.wake_forward.restype = ctypes.c_int
    lib.wake_forward.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.wake_train_step.restype = ctypes.c_float
    lib.wake_train_step.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_float,
    ]
    lib.wake_save.restype = ctypes.c_int
    lib.wake_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wake_load.restype = ctypes.c_void_p
    lib.wake_load.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 3
    return lib


class NativeWakeModel:
    """The reference CNN detector (conv 32/64/128 + pools + MLP + softmax
    over event-time bins) backed by the C++ implementation."""

    def __init__(
        self,
        seq_len: int,
        n_features: int = 2,
        n_classes: int | None = None,
        *,
        seed: int = 42,
        lib_path: Path | None = None,
        _handle=None,
        _lib=None,
    ):
        self.seq_len = seq_len
        self.n_features = n_features
        self.n_classes = n_classes or seq_len
        self._lib = _lib or _load(lib_path)
        if _handle is not None:
            self._handle = _handle
        else:
            self._handle = self._lib.wake_create(
                seq_len, n_features, self.n_classes, seed
            )
            if not self._handle:
                raise RuntimeError("wake_create failed (seq_len >= 226 required)")

    # ------------------------------------------------------------------
    def _check_input(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.shape != (self.seq_len, self.n_features):
            raise ValueError(
                f"expected ({self.seq_len}, {self.n_features}), got {x.shape}"
            )
        return x

    def forward(self, x: np.ndarray) -> tuple[int, np.ndarray]:
        """Returns (argmax class, class probabilities)."""
        x = self._check_input(x)
        probs = np.zeros(self.n_classes, np.float32)
        pred = self._lib.wake_forward(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if pred < 0:
            raise RuntimeError("wake_forward failed")
        return pred, probs

    def predict_time(self, x: np.ndarray, *, bin_seconds: float = 7.0) -> float:
        """Event time in seconds (reference prints argmax*7, train.cpp:105)."""
        pred, _ = self.forward(x)
        return pred * bin_seconds

    def train_step(self, x: np.ndarray, label: int, lr: float = 0.1) -> float:
        x = self._check_input(x)
        loss = self._lib.wake_train_step(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(label),
            float(lr),
        )
        if loss < 0:
            raise RuntimeError("wake_train_step failed")
        return float(loss)

    def save(self, path: str | Path) -> None:
        if self._lib.wake_save(self._handle, str(path).encode()) != 0:
            raise RuntimeError(f"wake_save failed: {path}")

    @classmethod
    def load(
        cls, path: str | Path, seq_len: int, n_features: int = 2,
        n_classes: int | None = None, *, lib_path: Path | None = None,
    ) -> "NativeWakeModel":
        lib = _load(lib_path)
        handle = lib.wake_load(
            str(path).encode(), seq_len, n_features, n_classes or seq_len
        )
        if not handle:
            raise RuntimeError(f"wake_load failed: {path}")
        return cls(
            seq_len, n_features, n_classes, _handle=handle, _lib=lib
        )

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.wake_free(self._handle)
            self._handle = None
