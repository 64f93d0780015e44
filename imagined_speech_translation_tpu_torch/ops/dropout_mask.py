"""The attention-dropout keep-mask: its plain version, the tile sizes it is
defined on, and the probe kernel that writes one tile of it on the card.

Port of the mask logic in ``imagined_speech_translation_tpu.ops.
pallas_attention``: ``_dropout_threshold``, ``_hash_bits`` (the portable
counter hash the JAX kernels use in interpret mode), ``_tile_keep_mask``,
``dropout_keep_mask_reference`` (the JAX package's host oracle) and
``flash_attention``'s dropout tile sizes and tile-id limit.  The CUDA
kernels (``csrc/dropout_mask.cuh``) draw the same bits, so on the CPU and on
the card the port's masks equal the oracle's bit for bit.

The hash works in unsigned 32-bit arithmetic that wraps; the plain version
here computes in int64 and masks to 32 bits after every multiply and add.
"""

from __future__ import annotations

import torch

from .._kernels import DROPOUT_MASK

_M32 = 0xFFFFFFFF
#: the tile id packs (bh, q-tile, k-tile) as (bh * 256 + qi) * 256 + ki
TILE_LIMIT = 256
BH_LIMIT = 32768


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def dropout_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = rate for uniform uint32 bits."""
    return min(int(round(rate * 2.0**32)), 2**32 - 1)


def dropout_blocks(bh: int, s_q: int, s_kv: int, dtype: torch.dtype,
                   block_q: int | None = None, block_k: int | None = None) -> tuple[int, int]:
    """The logical (block_q, block_k) tiles the mask of ``bh`` heads is
    defined on, as ``flash_attention`` picks them with dropout on: 256 query
    rows and 512 keys at 2-byte storage (256 at 4-byte), each at most the
    sequence rounded up to 128.  Raises ``ValueError`` when the tile id
    would not fit its packing (q-tiles or k-tiles >= 256, heads >= 32768)."""
    if block_q is None:
        block_q = min(256, _round_up(s_q, 128))
    if block_k is None:
        wide = torch.empty((), dtype=dtype).element_size() <= 2
        block_k = min(512 if wide else 256, _round_up(s_kv, 128))
    n_q, n_k = -(-s_q // block_q), -(-s_kv // block_k)
    if n_q >= TILE_LIMIT or n_k >= TILE_LIMIT or bh >= BH_LIMIT:
        raise ValueError(
            f"dropout tile-id packing limit exceeded: need q-tiles {n_q} < 256, "
            f"k-tiles {n_k} < 256, batch*heads {bh} < 32768 (raise block_q/block_k "
            "or split the batch)"
        )
    return block_q, block_k


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for uint32 ``x`` in int64, without overflowing
    int64: the constant is split into its 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(seed: int, tile_id: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``_hash_bits`` of the elements at ``index`` (row * block_k + col) of
    tiles ``tile_id`` (int64 tensors that broadcast); uint32 values in int64."""
    x = (index + _mul32(tile_id, 0x9E3779B9) + (0x85EBCA6B * seed) % 2**32) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _head_keep_mask(seed: int, bh: int, row0: int, n_rows: int, col0: int, n_cols: int, *,
                    block_q: int, block_k: int, rate: float, device) -> torch.Tensor:
    """Head ``bh``'s boolean keep-mask (True = keep) over rows
    ``row0 .. row0 + n_rows`` and columns ``col0 .. col0 + n_cols``; rows and
    columns past the sequence extend the last tile as the kernels see it."""
    rows = torch.arange(row0, row0 + n_rows, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(col0, col0 + n_cols, device=device, dtype=torch.int64)[None, :]
    index = (rows % block_q) * block_k + cols % block_k
    tile = (bh * TILE_LIMIT + rows // block_q) * TILE_LIMIT + cols // block_k
    return hash_bits(seed, tile, index) >= dropout_threshold(rate)


def dropout_keep_mask_reference(
    seed: int, b: int, h: int, s_q: int, s_kv: int, *, block_q: int, block_k: int,
    rate: float, device: torch.device | str = "cpu",
) -> torch.Tensor:
    """The dense ``(b, h, s_q, s_kv)`` boolean keep-mask (True = keep) that
    the kernels draw for ``seed``: JAX's ``dropout_keep_mask_reference``.
    Built one head at a time to bound the int64 temporaries."""
    kw = dict(block_q=block_q, block_k=block_k, rate=rate, device=device)
    out = torch.empty((b * h, s_q, s_kv), dtype=torch.bool, device=device)
    for bh in range(b * h):
        out[bh] = _head_keep_mask(seed, bh, 0, s_q, 0, s_kv, **kw)
    return out.reshape(b, h, s_q, s_kv)


def tile_keep_mask_reference(seed: int, bh: int, qi: int, ki: int, *, block_q: int,
                             block_k: int, rate: float, device="cpu") -> torch.Tensor:
    """Plain twin of the probe kernel: tile ``(qi, ki)`` of head ``bh`` as
    float32 ``(block_q, block_k)``, 1 = keep."""
    return _head_keep_mask(seed, bh, qi * block_q, block_q, ki * block_k, block_k,
                           block_q=block_q, block_k=block_k, rate=rate, device=device).float()


def tile_keep_mask(seed: int, bh: int, qi: int, ki: int, *, block_q: int, block_k: int,
                   rate: float, device="cuda") -> torch.Tensor:
    """Tile ``(qi, ki)`` of head ``bh``'s keep-mask as float32, written by the
    probe kernel on a CUDA ``device`` (the plain twin on the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return tile_keep_mask_reference(seed, bh, qi, ki, block_q=block_q, block_k=block_k,
                                        rate=rate)
    if device.type != "cuda":
        raise ValueError(f"tile_keep_mask runs on a CUDA device or the CPU, not {device}")
    out = torch.empty((block_q, block_k), dtype=torch.float32, device=device)
    DROPOUT_MASK.launch(
        out.data_ptr(), bh, qi, ki, block_q, block_k, int(seed), dropout_threshold(rate),
        torch.cuda.current_stream(device).cuda_stream,
    )
    return out
