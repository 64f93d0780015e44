"""Unmasked attention with optional dropout through the hand-written CUDA
kernels, differentiable.

Port of ``imagined_speech_translation_tpu.ops.pallas_attention``'s
``flash_attention`` and its custom VJP ``_flash_core``.  For tensors on the
card the forward launches ``csrc/flash_fwd.cu`` and saves ``q, k, v``, the
output, the base-2 logsumexp and the dropout seed; the backward computes
``delta = rowsum(dO * O)`` in float32 and dispatches as ``_flash_core_bwd``
does (:func:`backward_route`): with dropout it launches the fused backward
``csrc/flash_bwd.cu``, which regenerates the mask; at rate 0 the split
kernels of ``csrc/flash_bwd_split.cu``, dQ and then dK/dV, whose results do
not depend on launch timing (the fused kernel adds dQ with atomics).  The
split kernels regenerate no mask, so their tiles are their own and
``dropout_blocks`` binds only the rate > 0 path.  For tensors on the CPU
``flash_attention`` runs ``flash_attention_reference`` (the plain
softmax(QK^T)V with the same keep-mask), and autograd differentiates it.
"""

from __future__ import annotations

import math

import torch

from .._kernels import FLASH_BWD, FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD
from .dropout_mask import dropout_blocks, dropout_keep_mask_reference, dropout_threshold

LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, *, scale: float | None = None, dropout_rate: float = 0.0,
                              dropout_seed: int = 0, block_q: int | None = None,
                              block_k: int | None = None):
    """Plain twin of the kernels over ``(B, H, S, D)``: logits in float32,
    softmax, kept probabilities scaled by ``1 / (1 - rate)`` and dropped ones
    zeroed, cast back to ``v``'s dtype.  Returns ``(out, lse)`` with ``lse``
    the base-2 logsumexp of the scaled scores, float32 ``(B*H, S_q)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0:
        b, h, s_q, s_kv = logits.shape
        block_q, block_k = dropout_blocks(b * h, s_q, s_kv, q.dtype, block_q, block_k)
        keep = dropout_keep_mask_reference(dropout_seed, b, h, s_q, s_kv, block_q=block_q,
                                           block_k=block_k, rate=dropout_rate, device=q.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_rate)), 0.0)
    out = torch.matmul(probs.to(v.dtype), v)
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
    if not 0 < q.shape[-1] <= 256:
        raise ValueError(f"flash_attention kernel takes a head dim <= 256, got {q.shape[-1]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q/k/v")


def _dropout_args(drop):
    """The kernels' dropout arguments for ``drop = (rate, seed, block_q,
    block_k)``: on-flag, seed, threshold, tiles and 1 / (1 - rate)."""
    rate, seed, block_q, block_k = drop
    if rate == 0.0:
        return 0, 0, 0, 0, 0, 1.0
    return 1, seed, dropout_threshold(rate), block_q, block_k, 1.0 / (1.0 - rate)


def _forward(q, k, v, scale, drop):
    b, h, s_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, s_q, k.shape[2], d, float(scale) * LOG2E, _DTYPES[q.dtype], *_dropout_args(drop),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def backward_route(dropout_rate: float) -> tuple[str, ...]:
    """The kernels the backward launches at ``dropout_rate``, in order, as
    ``_flash_core_bwd`` picks them: the fused kernel when dropout is on (each
    tile's mask drawn once for all three gradients), the split dQ and dK/dV
    kernels at rate 0."""
    if dropout_rate > 0.0:
        return (FLASH_BWD.name,)
    return (FLASH_BWD_DQ.name, FLASH_BWD_DKV.name)


def _check_backward(q, k, v, dout, lse, delta) -> None:
    _check(q, k, v)
    b, h, s_q, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device or (
        not dout.is_contiguous()
    ):
        raise ValueError(f"flash backward: dout {dout.dtype} {tuple(dout.shape)} on "
                         f"{dout.device} does not match q")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b * h, s_q) or t.dtype != torch.float32 or t.device != q.device or (
            not t.is_contiguous()
        ):
            raise ValueError(f"flash backward: {name} must be contiguous float32 "
                             f"{(b * h, s_q)} on {q.device}, got {t.dtype} {tuple(t.shape)}")


def backward_fused(q, k, v, dout, lse, delta, scale, drop):
    """dQ, dK, dV from the fused kernel over contiguous ``(B, H, S, D)``
    ``q, k, v, dout`` of one dtype on the card, ``lse`` and ``delta``
    float32 ``(B*H, S_q)``, and ``drop = (rate, seed, block_q, block_k)``."""
    _check_backward(q, k, v, dout, lse, delta)
    b, h, s_q, d = q.shape
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, s_q, k.shape[2], d, float(scale) * LOG2E, float(scale), _DTYPES[q.dtype],
        *_dropout_args(drop), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq.to(q.dtype), dk, dv


def _split_args(q, k, v, dout, lse, delta, scale):
    """Input pointers and sizes of the split kernels' C entry points."""
    _check_backward(q, k, v, dout, lse, delta)
    b, h, s_q, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    dims = (b * h, s_q, k.shape[2], d, float(scale) * LOG2E, float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return ptrs, dims


def backward_dq(q, k, v, dout, lse, delta, scale):
    """dQ from the split dQ kernel (dropout off), on the inputs of
    :func:`backward_fused`."""
    ptrs, dims = _split_args(q, k, v, dout, lse, delta, scale)
    dq = torch.empty_like(q)
    FLASH_BWD_DQ.launch(*ptrs, dq.data_ptr(), *dims)
    return dq


def backward_dkv(q, k, v, dout, lse, delta, scale):
    """dK, dV from the split dK/dV kernel (dropout off), on the inputs of
    :func:`backward_fused`."""
    ptrs, dims = _split_args(q, k, v, dout, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD_DKV.launch(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims)
    return dk, dv


def backward_split(q, k, v, dout, lse, delta, scale):
    """dQ, dK, dV from the split kernels: dQ first, then dK and dV."""
    return (backward_dq(q, k, v, dout, lse, delta, scale),
            *backward_dkv(q, k, v, dout, lse, delta, scale))


def _backward(q, k, v, out, lse, dout, scale, drop):
    b, h, s_q, d = q.shape
    delta = (dout.float() * out.float()).sum(dim=-1).reshape(b * h, s_q)
    dout = dout.to(q.dtype).contiguous()
    if backward_route(drop[0]) == (FLASH_BWD.name,):
        return backward_fused(q, k, v, dout, lse, delta, scale, drop)
    return backward_split(q, k, v, dout, lse, delta, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, drop):
        out, lse = _forward(q, k, v, scale, drop)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.drop = scale, drop
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.scale, ctx.drop)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, scale: float | None = None, dropout_rate: float = 0.0,
                    dropout_seed: int | None = None, block_q: int | None = None,
                    block_k: int | None = None):
    """Unmasked attention over ``(B, H, S, D)`` with optional attention-
    probability dropout; returns ``(out, lse)`` as
    :func:`flash_attention_reference` does, differentiable in ``q, k, v``.

    ``dropout_seed`` (an int32) is required when ``dropout_rate > 0``; the
    mask is defined on the logical tiles ``block_q x block_k``, by default
    those the JAX package picks (:func:`~.dropout_mask.dropout_blocks`).  A
    CUDA tensor launches the kernels (or raises); a CPU tensor takes the
    plain twin."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    drop = (0.0, 0, 0, 0)
    if dropout_rate > 0.0:
        b, h, s_q, _ = q.shape
        block_q, block_k = dropout_blocks(b * h, s_q, k.shape[2], q.dtype, block_q, block_k)
        drop = (float(dropout_rate), int(dropout_seed), block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale, dropout_rate=dropout_rate,
                                         dropout_seed=drop[1], block_q=block_q, block_k=block_k)
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(scale), drop)
    return _forward(q, k, v, scale, drop)
