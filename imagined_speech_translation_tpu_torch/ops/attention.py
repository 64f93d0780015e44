"""Scaled-dot-product attention over ``(batch, heads, seq, head_dim)``.

Port of ``imagined_speech_translation_tpu.ops.attention``.  The dispatch is
the JAX package's ``_flash_available`` rule without its backend test: the
flash route when there is no mask, both sequences are at least 128 long and
the head dim is at most 256; the float32-logit softmax path otherwise.  The
flash route launches the CUDA kernel for a tensor on the card and runs its
plain twin for a tensor on the CPU (``ops.flash_attention``).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention


def _softmax_attention(q, k, v, mask, scale):
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


def flash_route(q, k, mask) -> bool:
    """Whether :func:`dot_product_attention` takes the flash route."""
    if mask is not None:  # the kernel is unmasked-only (encoder pattern)
        return False
    return q.shape[-2] >= 128 and k.shape[-2] >= 128 and q.shape[-1] <= 256


def dot_product_attention(q, k, v, mask=None, *, scale: float | None = None):
    """Attention over ``(B, H, S, D)``; ``mask`` broadcasts against
    ``(B, H, Q, K)`` with True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if flash_route(q, k, mask):
        return flash_attention(q, k, v, scale=scale)[0]
    return _softmax_attention(q, k, v, mask, scale)
