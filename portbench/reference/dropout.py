"""Dropout masks by the port's published protocol, for the reference's
train mode.

Every dropout draws one int32 seed from the step's CPU generator
(``torch.randint(0, 2**31 - 1, ())``).  An elementwise mask, or the mask
of a masked or short attention, is ``torch.bernoulli`` of the keep
probability on a generator of the tensor's device seeded with it.  A long
unmasked attention (both sequences at least 128, head dim at most 256) is
masked inside the flash kernels by a counter hash over tiles of
``block_q x block_k`` probabilities (``csrc/dropout_mask.cuh``): 256 query
rows, and 512 keys where the kernel's operands take 2 bytes (256 where
they take 4), each at most the sequence rounded up to 128.  The hash is
written out again here, in int64 arithmetic masked to 32 bits.
"""

from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF
_TILES = 256


def draw_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, _INT32_MAX, (), generator=generator))


def bernoulli_keep(shape, keep_prob: float, device, generator: torch.Generator):
    on_device = torch.Generator(device=device).manual_seed(draw_seed(generator))
    return torch.bernoulli(torch.full(shape, keep_prob, device=device),
                           generator=on_device).bool()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(seed: int, tile: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    x = (index + _mul32(tile, 0x9E3779B9) + (0x85EBCA6B * seed) % 2**32) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def attention_keep(generator: torch.Generator, bh: int, heads: int, s_q: int, s_kv: int,
                   rate: float, operand_bytes: int, device) -> torch.Tensor:
    """The ``(bh // heads, heads, s_q, s_kv)`` keep-mask of a long attention
    over ``bh`` heads; draws the call's seed."""
    seed = draw_seed(generator)
    block_q = min(256, _round_up(s_q, 128))
    block_k = min(512 if operand_bytes <= 2 else 256, _round_up(s_kv, 128))
    threshold = min(int(round(rate * 2.0**32)), 2**32 - 1)
    rows = torch.arange(s_q, device=device, dtype=torch.int64)[:, None]
    cols = torch.arange(s_kv, device=device, dtype=torch.int64)[None, :]
    index = (rows % block_q) * block_k + cols % block_k
    tile_rc = (rows // block_q) * _TILES + cols // block_k
    out = torch.empty((bh, s_q, s_kv), dtype=torch.bool, device=device)
    step = 8
    for h0 in range(0, bh, step):
        hs = torch.arange(h0, min(h0 + step, bh), device=device, dtype=torch.int64)
        tile = hs[:, None, None] * (_TILES * _TILES) + tile_rc[None]
        out[h0: h0 + len(hs)] = hash_bits(seed, tile, index[None]) >= threshold
    return out.reshape(bh // heads, heads, s_q, s_kv)
