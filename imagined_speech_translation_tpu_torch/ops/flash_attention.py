"""Unmasked attention forward through the hand-written CUDA kernel.

``flash_attention`` launches ``csrc/flash_fwd.cu`` for tensors on the card and
runs ``flash_attention_reference`` (the plain softmax(QK^T)V it replaces) for
tensors on the CPU.  Forward only, no dropout: the serving path.  The
autograd function arrives with the backward kernel.
"""

from __future__ import annotations

import math

import torch

from .._kernels import FLASH_FWD

LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, *, scale: float | None = None):
    """Plain twin of the kernel over ``(B, H, S, D)``: logits in float32,
    softmax, probabilities cast back to ``v``'s dtype.  Returns ``(out,
    lse)`` with ``lse`` the base-2 logsumexp of the scaled scores,
    float32 ``(B*H, S_q)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    out = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
    lse = torch.logsumexp(logits, dim=-1).reshape(-1, q.shape[-2]) * LOG2E
    return out, lse


def _check(q, k, v) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: q/k/v on {q.device}/{k.device}/{v.device}, "
            "need one CUDA device"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] or (
        k.shape[-1] != q.shape[-1]
    ):
        raise ValueError(f"flash_attention: bad shapes q {q.shape} k {k.shape} v {v.shape}")
    if not (0 < q.shape[-1] <= 256 and q.shape[-1] % 8 == 0):
        raise ValueError(
            f"flash_attention kernel takes a head dim <= 256 that is a multiple of 8, "
            f"got {q.shape[-1]}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q/k/v")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention kernel is forward-only (no backward yet)")


def flash_attention(q, k, v, *, scale: float | None = None):
    """Unmasked attention over ``(B, H, S, D)``; returns ``(out, lse)`` as
    :func:`flash_attention_reference` does.  A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    _check(q, k, v)
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, s_q, s_kv, d, float(scale) * LOG2E, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse
