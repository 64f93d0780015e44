"""Scaled-dot-product attention over ``(batch, heads, seq, head_dim)``.

Port of ``imagined_speech_translation_tpu.ops.attention``.  The dispatch is
the JAX package's ``_flash_available`` rule without its backend test: the
flash route when there is no mask, both sequences are at least 128 long and
the head dim is at most 256; the float32-logit softmax path otherwise.  The
flash route launches the CUDA kernels for a tensor on the card and runs their
plain twin for a tensor on the CPU (``ops.flash_attention``).

Attention-probability dropout takes a CPU ``torch.Generator``: the flash
route draws its int32 kernel seed from it, the softmax route a Bernoulli
mask (``ops.random``).  As in the JAX package, the two routes draw
different bits.  Under data parallelism both draw the single-device step's
bits for this rank's rows: the attention batch is ``fold * rows`` (the
regions fold into it), and the flash kernels map their heads
(``parallel.data_parallel.dropout_rows``).  Under tensor parallelism the
BART attention holds this rank's heads (``model_dim=1``): the softmax route
draws the mask for every head and keeps the rank's; the flash kernels' mask
has no such mapping, so the flash route refuses dropout there (BART's masked
attention never takes it).
"""

from __future__ import annotations

import torch

from ..parallel import data_parallel, tensor_parallel
from .flash_attention import flash_attention
from .random import bernoulli_keep, draw_seed


def _softmax_attention(q, k, v, mask, scale, dropout_rate=0.0, generator=None,
                       model_dim=None):
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        keep = bernoulli_keep(probs.shape, 1.0 - dropout_rate, probs.device, generator,
                              model_dim=model_dim)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.matmul(probs.to(v.dtype), v)


def flash_route(q, k, mask) -> bool:
    """Whether :func:`dot_product_attention` takes the flash route."""
    if mask is not None:  # the kernel is unmasked-only (encoder pattern)
        return False
    return q.shape[-2] >= 128 and k.shape[-2] >= 128 and q.shape[-1] <= 256


def dot_product_attention(q, k, v, mask=None, *, scale: float | None = None,
                          dropout_rate: float = 0.0,
                          generator: torch.Generator | None = None,
                          model_dim: int | None = None):
    """Attention over ``(B, H, S, D)``; ``mask`` broadcasts against
    ``(B, H, Q, K)`` with True = attend.  ``dropout_rate > 0`` needs
    ``generator``; ``model_dim`` is the dimension (the heads) that a
    tensor-parallel block splits."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout_rate > 0 requires a generator")
    if flash_route(q, k, mask):
        if dropout_rate > 0.0 and model_dim is not None and tensor_parallel.active():
            raise ValueError("the flash kernels' dropout mask has no model-axis head mapping: "
                             "tensor-parallel heads with dropout take a masked attention")
        seed = draw_seed(generator) if dropout_rate > 0.0 else None
        rows = data_parallel.dropout_rows(q.shape[0]) if dropout_rate > 0.0 else None
        return flash_attention(q, k, v, scale=scale, dropout_rate=dropout_rate,
                               dropout_seed=seed, dropout_rows=rows)[0]
    return _softmax_attention(q, k, v, mask, scale, dropout_rate, generator, model_dim)
