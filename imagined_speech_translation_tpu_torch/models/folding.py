"""Inference-time BatchNorm folding for the region-encoder conv stems.

Port of ``imagined_speech_translation_tpu.models.folding``.  Eval BatchNorm is
a per-channel affine ``y = g*(x - m)/sqrt(v + eps) + c``; it folds into the
preceding conv as ``W' = W*g/sqrt(v + eps)`` and ``b' = (b - m)*g/sqrt(v+eps) +
c``, leaving a neutral BN behind (scale 1, stats ``m = 0, v = 1 - eps`` so
``sqrt(v + eps) == 1``; a bias-less conv keeps its shift in the BN bias).
Fold sites: ``stage{i}_convbn`` and ``stage{i}_residual`` (conv -> bn), and the
depthwise stage's ``stage{i}_bn`` into ``stage{i}_pointwise``.  Runs in
float32, before any cast to a narrower dtype.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from .layers import RegionConv, RegionConvAttentionEncoder, RegionNorm, _ConvBN


@torch.no_grad()
def _fold_one(conv: RegionConv, bn: RegionNorm) -> None:
    g = bn.weight / torch.sqrt(bn.running_var + bn.eps)  # (R, C)
    shift = bn.bias - bn.running_mean * g
    conv.weight.mul_(g[:, :, None, None])
    if conv.bias is not None:
        conv.bias.copy_(conv.bias * g + shift)
        shift = torch.zeros_like(shift)
    bn.weight.fill_(1.0)
    bn.bias.copy_(shift)
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - bn.eps)


def fold_batch_norm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every region-encoder BatchNorm folded into its
    conv.  Unchanged (still copied) for ``norm='group'``.  Inference only."""
    model = copy.deepcopy(model)
    for enc in model.modules():
        if not isinstance(enc, RegionConvAttentionEncoder) or enc.cfg.norm != "batch":
            continue
        for name, child in enc.named_children():
            if isinstance(child, _ConvBN):
                conv, bn = child.conv, child.bn
            elif isinstance(child, RegionNorm):  # depthwise stage: stage{i}_bn
                conv, bn = getattr(enc, name.replace("_bn", "_pointwise")), child
            else:
                continue
            if conv.weight.dtype != torch.float32:
                raise TypeError("fold BatchNorm in float32, before casting the model")
            _fold_one(conv, bn)
    return model
