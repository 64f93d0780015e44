"""The host memory policy of a long-lived serving process.

glibc's ``malloc`` maps a block of 128 KiB or more for itself and unmaps it
when it is freed, but it raises that threshold to the size of the largest
mapped block freed so far (up to 32 MiB).  After the first decode batch the
serving path's frames, windows and batches (0.4-13 MB at full width) then
come from the heap, and a heap keeps what they free wherever a live block
sits above it: the server's resident memory rises in steps though what it
holds does not.  :func:`return_freed_buffers` pins both thresholds, so such
buffers go back to the system when freed.  ``cli.serve.build_decode_fn``
calls it for a decode on a card, the one place every serving process
passes through: ``cli.serve``'s own, a ``DecodeWorker``'s child (whose
factory builds the decode function) and ``cli.streaming_soak``'s
full-size service.
"""

from __future__ import annotations

import ctypes

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
#: blocks from this size up are mapped for themselves; a free heap top
#: beyond it is given back
THRESHOLD_BYTES = 128 * 1024


def return_freed_buffers() -> bool:
    """Pin ``malloc``'s mmap and trim thresholds at :data:`THRESHOLD_BYTES`
    for this process.  Returns False where the C library has no ``mallopt``
    (not glibc), and changes nothing there."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    return bool(mallopt(M_MMAP_THRESHOLD, THRESHOLD_BYTES)) and bool(
        mallopt(M_TRIM_THRESHOLD, THRESHOLD_BYTES))
