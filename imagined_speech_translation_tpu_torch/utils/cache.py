"""Where the port's CUDA kernels are built and kept.

The counterpart of ``imagined_speech_translation_tpu.utils.cache``, which
points XLA's persistent compilation cache at a directory.  The port compiles
no XLA programs; what it compiles, once per source tree, is its kernel
library (``_kernels.py``: ``nvcc`` for every ``csrc/`` source, tens of
seconds).  :func:`enable_persistent_cache` chooses the directory that library
is built into and loaded from: ``directory``, else ``IST_COMPILE_CACHE``,
else ``build/kernels/`` at the repository root, which is also where the
kernels build when it is never called.  Called by every CLI entry point
where the JAX CLIs call theirs; safe to call several times, but a call that
would move the directory after the library was loaded from another raises.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_chosen: Path | None = None


def kernel_build_dir() -> Path:
    """The directory the kernel library is built into and loaded from."""
    return _chosen if _chosen is not None else DEFAULT_DIR


def enable_persistent_cache(directory: str | os.PathLike | None = None) -> str:
    """Choose the kernels' build directory (``directory``, else
    ``IST_COMPILE_CACHE``, else the default); returns it.  Raises if the
    kernel library was already loaded from another directory."""
    global _chosen
    from .. import _kernels

    path = Path(directory or os.environ.get("IST_COMPILE_CACHE") or DEFAULT_DIR)
    path = path.expanduser().resolve()
    loaded = _kernels.loaded_build_dir()
    if loaded is not None and loaded != path:
        raise RuntimeError(f"the kernel library is already loaded from {loaded}; "
                           f"cannot move its build directory to {path}")
    _chosen = path
    return str(path)
