"""Region-encoder building blocks.

Port of ``imagined_speech_translation_tpu.models.layers``.  The JAX package
runs four per-region encoders as an ``nn.vmap`` over the region axis; here the
four regions are one batched computation.  Every per-region weight carries a
leading region axis ``R``:

* Dense ``(R, out, in)``, applied with ``baddbmm`` over ``(R, N, in)``;
* Conv ``(R, out, in/groups, k)``, applied as one grouped ``conv1d`` over the
  channel-first ``(B, R*C, T)`` stem activations (``groups = R*groups``);
* LayerNorm / BatchNorm / GroupNorm affine and stats ``(R, C)``.

Token activations are ``(R, B, S, D)``: feature-last as in the JAX package,
with the region axis leading so that each region's Dense is one slab of a
batched matmul, and ``R*B`` folds into the attention batch.  Module and
parameter names follow the flax variable tree (``convert.py`` maps one to the
other).

Train mode follows flax's ``train=True``: BatchNorm normalizes with the
batch's statistics and updates its running ones (``self.training``), and
every dropout of the JAX module draws from the ``generator`` passed to
``forward`` (``None`` in eval mode: dropout is the identity).

Under data parallelism (``parallel.data_parallel``) BatchNorm's train-mode
statistics are the global batch's, and the region-stacked tensors tell the
dropouts that their batch rows lie on dimension 1.  Under tensor parallelism
(``parallel.tensor_parallel``, the JAX ``_TP_RULES``) the gated FFN's
``linear1`` and ``gate`` are column-parallel and ``linear2`` row-parallel,
and ``cnn_to_attn_fc1`` is column-parallel with its columns gathered before
``cnn_to_attn_ln1``; their biases stay replicated and each rank adds its
columns of them (:func:`column_parallel`, :func:`row_parallel`).  The
attention is replicated.  With ``seq_shards > 1`` the token attention runs
as ring attention over the ``seq_axis`` of the mesh that
``parallel.context.context_mesh`` installs, on tokens zero-padded to a
shard multiple whose padded keys it masks, without attention-prob dropout,
as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RegionEncoderConfig
from ..ops import dot_product_attention, dropout
from ..parallel import data_parallel, tensor_parallel
from ..parallel.context import get_context_mesh, ring_attention


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


def region_linear(x, weight, bias=None):
    """``(R, ..., in) -> (R, ..., out)`` with ``weight (R, out, in)`` and
    ``bias (R, out)``."""
    r, *mid, d = x.shape
    x2, wt = x.reshape(r, -1, d), weight.transpose(1, 2)
    y = torch.bmm(x2, wt) if bias is None else torch.baddbmm(bias.unsqueeze(1), x2, wt)
    return y.reshape(r, *mid, y.shape[-1])


class RegionLinear(nn.Module):
    """Per-region Dense: ``(R, ..., in) -> (R, ..., out)``."""

    def __init__(self, n_regions: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = _param(n_regions, out_features, in_features)
        self.bias = _param(n_regions, out_features)

    def forward(self, x):
        return region_linear(x, self.weight, self.bias)


def _linear(layer, x, weight, bias):
    if isinstance(layer, RegionLinear):
        return region_linear(x, weight, bias)
    return F.linear(x, weight, bias)


def column_parallel(layer: nn.Module, x):
    """``layer`` (a Dense of this rank's output columns under tensor
    parallelism) on ``x``, which :func:`tensor_parallel.copy_to_model`
    handed in; a replicated bias adds its columns of this rank."""
    if tensor_parallel.active() is None:
        return layer(x)
    bias = layer.bias
    if bias.shape[-1] != layer.weight.shape[-2]:
        bias = tensor_parallel.cols(tensor_parallel.copy_to_model(bias))
    return _linear(layer, x, layer.weight, bias)


def row_parallel(layer: nn.Module, x):
    """``layer`` (a Dense of this rank's input rows under tensor
    parallelism) on this rank's columns ``x``: the partial products summed
    over the model group, then the bias, once."""
    if tensor_parallel.active() is None:
        return layer(x)
    y = tensor_parallel.reduce_from_model(_linear(layer, x, layer.weight, None))
    bias = layer.bias
    if isinstance(layer, RegionLinear):
        bias = bias.reshape((bias.shape[0],) + (1,) * (y.dim() - 2) + (bias.shape[-1],))
    return y + bias


class RegionLayerNorm(nn.Module):
    """Per-region LayerNorm over the last axis of ``(R, ..., D)``."""

    def __init__(self, n_regions: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(n_regions, dim)
        self.bias = _param(n_regions, dim)

    def forward(self, x):
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        y = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def same_length(length: int, stride: int) -> int:
    """The output length of a flax ``padding='SAME'`` conv: ``ceil(T / s)``."""
    return -(-length // stride)


def same_padding(length: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax ``padding='SAME'``'s ``(left, right)`` zeros: the total
    ``max((ceil(T/s) - 1) * s + k - T, 0)``, its smaller half on the left."""
    total = max((same_length(length, stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class RegionConv(nn.Module):
    """Per-region 1-D conv with flax ``padding='SAME'`` on channel-first
    ``(B, R*in, T)``, any kernel and stride: ``ceil(T / s)`` outputs.  An
    odd kernel at stride 1 pads ``k // 2`` on both sides; otherwise the
    padding is asymmetric (:func:`same_padding`)."""

    def __init__(self, n_regions, in_ch, out_ch, kernel, *, stride=1, groups=1, bias=True):
        super().__init__()
        self.n_regions, self.groups, self.kernel, self.stride = n_regions, groups, kernel, stride
        self.weight = _param(n_regions, out_ch, in_ch // groups, kernel)
        self.bias = _param(n_regions, out_ch) if bias else None

    def forward(self, x):
        w = self.weight.flatten(0, 1)
        b = None if self.bias is None else self.bias.flatten()
        groups = self.n_regions * self.groups
        if self.stride == 1 and self.kernel % 2:
            return F.conv1d(x, w, b, padding=self.kernel // 2, groups=groups)
        x = F.pad(x, same_padding(x.shape[-1], self.kernel, self.stride))
        return F.conv1d(x, w, b, stride=self.stride, groups=groups)


class RegionNorm(nn.Module):
    """Per-region BatchNorm or GroupNorm on ``(B, R*C, T)``.

    BatchNorm is flax's ``nn.BatchNorm(momentum=0.9)``: in eval mode it
    normalizes with the running statistics; in train mode with the batch's
    mean and biased variance over ``(B, T)`` (computed in float32 as
    ``E[x^2] - E[x]^2``, as flax does), and it updates the running
    statistics to ``0.9 * running + 0.1 * batch`` -- torch momentum 0.1, and
    the biased variance where ``F.batch_norm`` would store the unbiased one.
    The running statistics enter that update in the activations' dtype, as
    the JAX train step casts them to bfloat16 under mixed precision, and
    are stored back in float32.  Under data parallelism the sums of x and
    x^2 and the count are all-reduced (with gradient) first, so every rank
    normalizes with, and stores, the global batch's statistics."""

    momentum = 0.9

    def __init__(self, n_regions, channels, norm: str, gn_groups: int, eps: float = 1e-5):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm, self.eps, self.n_groups = norm, eps, n_regions * gn_groups
        self.weight = _param(n_regions, channels)
        self.bias = _param(n_regions, channels)
        if norm == "batch":
            self.register_buffer("running_mean", torch.zeros(n_regions, channels))
            self.register_buffer("running_var", torch.ones(n_regions, channels))

    def forward(self, x):
        w, b = self.weight.flatten(), self.bias.flatten()
        if self.norm == "group":
            return F.group_norm(x, self.n_groups, w, b, self.eps)
        if not self.training:
            return F.batch_norm(
                x, self.running_mean.flatten(), self.running_var.flatten(), w, b,
                training=False, eps=self.eps,
            )
        xf = x.float()
        if data_parallel.active() is None:
            mean = xf.mean(dim=(0, 2))
            var = ((xf * xf).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
        else:
            count = xf.new_full((xf.shape[1],), xf.shape[0] * xf.shape[2])
            sums = data_parallel.all_reduce_sum(
                torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2)), count]))
            mean = sums[0] / sums[2]
            var = (sums[1] / sums[2] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                old = buf.flatten().to(x.dtype)
                buf.copy_((self.momentum * old + (1 - self.momentum) * stat).view(buf.shape))
        y = (xf - mean[:, None]) * (torch.rsqrt(var + self.eps) * w.float())[:, None]
        return (y + b.float()[:, None]).to(x.dtype)


def dense(n_regions: int | None, in_features: int, out_features: int) -> nn.Module:
    if n_regions is None:
        return nn.Linear(in_features, out_features)
    return RegionLinear(n_regions, in_features, out_features)


class SqueezeExcite(nn.Module):
    """Channel attention on the stem output ``(B, R*C, T)``."""

    def __init__(self, n_regions: int, channels: int, reduction: int = 16):
        super().__init__()
        self.n_regions = n_regions
        self.fc1 = RegionLinear(n_regions, channels, max(1, channels // reduction))
        self.fc2 = RegionLinear(n_regions, max(1, channels // reduction), channels)

    def forward(self, x):
        b = x.shape[0]
        squeezed = x.mean(dim=-1).reshape(b, self.n_regions, -1).transpose(0, 1)
        e = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeezed))))  # (R, B, C)
        return x * e.transpose(0, 1).reshape(b, -1, 1)


class GatedFFN(nn.Module):
    """``linear2(dropout(gelu(linear1(x)) * sigmoid(gate(x))))``."""

    def __init__(self, n_regions, dim: int, hidden_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = dense(n_regions, dim, hidden_dim)
        self.gate = dense(n_regions, dim, hidden_dim)
        self.linear2 = dense(n_regions, hidden_dim, dim)

    def forward(self, x, generator=None):
        x = tensor_parallel.copy_to_model(x)
        h = gelu(column_parallel(self.linear1, x)) * torch.sigmoid(column_parallel(self.gate, x))
        return row_parallel(self.linear2, dropout(h, self.dropout, generator, model_dim=-1))


class MultiHeadAttention(nn.Module):
    """MHA over ``(..., S, D)`` with separate q/k/v/out projections, no cache.

    With ``n_regions`` the projections are per region and the input is
    ``(R, B, S, D)``; ``R*B`` folds into the attention batch.  With a
    generator, attention probabilities drop out at rate ``dropout``.  With
    ``seq_shards > 1`` the attention is ``parallel.context.ring_attention``
    over the ``seq_axis`` of the context mesh, with the key validity
    ``kv_valid`` and no attention-prob dropout (the JAX contract)."""

    def __init__(self, dim: int, num_heads: int, n_regions: int | None = None,
                 seq_shards: int = 1, dropout: float = 0.0, seq_axis: str = "seq"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
        self.num_heads, self.dropout = num_heads, dropout
        self.seq_shards, self.seq_axis = seq_shards, seq_axis
        self.q_proj = dense(n_regions, dim, dim)
        self.k_proj = dense(n_regions, dim, dim)
        self.v_proj = dense(n_regions, dim, dim)
        self.out_proj = dense(n_regions, dim, dim)

    def _split(self, t):
        s, d = t.shape[-2:]
        return t.reshape(-1, s, self.num_heads, d // self.num_heads).transpose(1, 2).contiguous()

    def forward(self, q_in, kv_in=None, generator=None, kv_valid=None):
        kv_in = q_in if kv_in is None else kv_in
        q = self._split(self.q_proj(q_in))
        k = self._split(self.k_proj(kv_in))
        v = self._split(self.v_proj(kv_in))
        if self.seq_shards > 1:
            mesh = get_context_mesh()
            if mesh is None:
                raise RuntimeError("seq_shards>1 requires the mesh: run the model inside "
                                   "parallel.context.context_mesh(mesh)")
            out = ring_attention(q, k, v, mesh=mesh, axis=self.seq_axis, kv_valid=kv_valid)
        else:
            if kv_valid is not None:
                raise ValueError("kv_valid is only used on the seq_shards>1 path")
            out = dot_product_attention(
                q, k, v, dropout_rate=self.dropout if generator is not None else 0.0,
                generator=generator,
            )
        return self.out_proj(out.transpose(1, 2).reshape(q_in.shape))


class _ConvBN(nn.Module):
    def __init__(self, n_regions, in_ch, out_ch, kernel, *, stride=1, bias, norm, gn_groups):
        super().__init__()
        self.conv = RegionConv(n_regions, in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.bn = RegionNorm(n_regions, out_ch, norm, gn_groups)

    def forward(self, x):
        return self.bn(self.conv(x))


def stem_stages(cfg: RegionEncoderConfig):
    """``(i, features, kernel, stride)`` of each conv stem stage, as the JAX
    module zips them."""
    return [(i, *s) for i, s in enumerate(zip(cfg.conv_channels, cfg.conv_kernels,
                                               cfg.conv_strides))]


def stem_length(cfg: RegionEncoderConfig, n_timepoints: int) -> int:
    """The conv stem's output length: ``ceil(T / s)`` at each stage but the
    depthwise one, which ignores its stride (as the JAX module does)."""
    t = n_timepoints
    for i, _, _, stride in stem_stages(cfg):
        if i != cfg.depthwise_stage:
            t = same_length(t, stride)
    return t


class RegionConvAttentionEncoder(nn.Module):
    """All regions' encoders: conv stem -> SE -> token attention -> pooled
    feature.  Input ``(B, R, C_in, T)``, output ``(R, B, hidden_dim)``.

    A stage with a stride other than 1 (the depthwise stage excepted) gives
    ``ceil(T / s)`` tokens and a strided 1x1 residual, as in JAX; the
    positions are sized from the stem's output length."""

    def __init__(self, cfg: RegionEncoderConfig, hidden_dim: int, *, n_regions: int,
                 in_channels: int, n_timepoints: int):
        super().__init__()
        self.cfg, self.h, self.n_regions = cfg, hidden_dim, n_regions
        R, h = n_regions, hidden_dim
        norm = dict(norm=cfg.norm, gn_groups=cfg.groupnorm_groups)
        c_in = in_channels
        for i, feats, kern, stride in stem_stages(cfg):
            if i == cfg.depthwise_stage:
                self.add_module(f"stage{i}_depthwise", RegionConv(R, c_in, c_in, kern, groups=c_in))
                self.add_module(f"stage{i}_pointwise", RegionConv(R, c_in, feats, 1))
                self.add_module(f"stage{i}_bn", RegionNorm(R, feats, **norm))
            else:
                if c_in != feats or stride != 1:
                    self.add_module(f"stage{i}_residual", _ConvBN(
                        R, c_in, feats, 1, stride=stride, bias=False, **norm))
                self.add_module(f"stage{i}_convbn", _ConvBN(
                    R, c_in, feats, kern, stride=stride, bias=True, **norm))
            c_in = feats
        self.se = SqueezeExcite(R, c_in, cfg.se_reduction)
        self.c_out = c_in
        if not cfg.cnn_only:
            self.cnn_to_attn_fc1 = RegionLinear(R, c_in, h * 2)
            self.cnn_to_attn_ln1 = RegionLayerNorm(R, h * 2)
            self.cnn_to_attn_fc2 = RegionLinear(R, h * 2, h)
            self.cnn_to_attn_ln2 = RegionLayerNorm(R, h)
            self.cnn_to_attn_fc3 = RegionLinear(R, h, h)
            nt = cfg.num_temporal_tokens
            self.cls_token = _param(R, 1, 1, h)
            self.temporal_tokens = _param(R, 1, nt, h)
            if cfg.use_positional_embedding:
                self.pos_emb = _param(R, 1, stem_length(cfg, n_timepoints) + 1 + nt, h)
            if cfg.num_attn_layers > 1:  # it follows every layer but the first
                self.cross_scale_attn = MultiHeadAttention(
                    h, cfg.attn_heads[0] // 2, R, cfg.seq_shards, dropout=0.1,
                    seq_axis=cfg.seq_axis,
                )
            for i in range(cfg.num_attn_layers):
                self.add_module(f"attn{i}_norm", RegionLayerNorm(R, h))
                self.add_module(
                    f"attn{i}",
                    MultiHeadAttention(h, cfg.attn_heads[i], R, cfg.seq_shards, dropout=0.1,
                                       seq_axis=cfg.seq_axis),
                )
                self.add_module(f"ffn{i}_norm", RegionLayerNorm(R, h))
                self.add_module(f"ffn{i}", GatedFFN(R, h, h * (4 if i == 0 else 2)))
        for i in range(3):
            self.add_module(f"multi_scale_proj{i}_fc", RegionLinear(R, h if not cfg.cnn_only else c_in, h))
            self.add_module(f"multi_scale_proj{i}_ln", RegionLayerNorm(R, h))
        self.projection_fc1 = RegionLinear(R, 3 * h, 2 * h)
        self.projection_ln1 = RegionLayerNorm(R, 2 * h)
        self.projection_fc2 = RegionLinear(R, 2 * h, h)
        self.projection_ln2 = RegionLayerNorm(R, h)
        self.diversity_head = RegionLinear(R, h, h)

    def _stem(self, x, gen):
        cfg = self.cfg
        light, med, heavy = cfg.dropout_tiers
        for i, *_ in stem_stages(cfg):
            if i == cfg.depthwise_stage:
                y = getattr(self, f"stage{i}_depthwise")(x)
                y = getattr(self, f"stage{i}_pointwise")(y)
                x = dropout(gelu(getattr(self, f"stage{i}_bn")(y)), med, gen)
                continue
            res = getattr(self, f"stage{i}_residual", None)
            residual = x if res is None else res(x)
            y = gelu(getattr(self, f"stage{i}_convbn")(x) + residual)
            x = dropout(y, light if i < 2 else (med if i < 4 else heavy), gen)
        return dropout(self.se(x), heavy, gen)

    def forward(self, x, generator=None):
        """``generator``: the dropout stream in train mode, ``None`` in eval."""
        b, r, c, t = x.shape
        x = self._stem(x.reshape(b, r * c, t), generator)  # (B, R*C, T')
        # (B, R*C, T') -> (R, B, T', C): feature-last tokens, region leading
        x = x.reshape(b, r, self.c_out, x.shape[-1]).permute(1, 0, 3, 2)
        with data_parallel.batch_on(1):
            return self._tokens(x, generator)

    def _tokens(self, x, generator):
        """The region-stacked part of :meth:`forward`: ``(R, B, T, C)`` stem
        tokens -> ``(R, B, hidden_dim)``."""
        r, b = x.shape[:2]
        if self.cfg.cnn_only:
            return self._cnn_only_pool(x, generator)
        cfg = self.cfg
        light, med, _ = cfg.dropout_tiers
        y = tensor_parallel.gather_cols(
            column_parallel(self.cnn_to_attn_fc1, tensor_parallel.copy_to_model(x)))
        y = dropout(gelu(self.cnn_to_attn_ln1(y)), 0.1, generator)
        y = dropout(gelu(self.cnn_to_attn_ln2(self.cnn_to_attn_fc2(y))), 0.05, generator)
        x = self.cnn_to_attn_fc3(y)

        nt = cfg.num_temporal_tokens
        x = torch.cat(
            [self.cls_token.expand(r, b, 1, self.h), self.temporal_tokens.expand(r, b, nt, self.h), x],
            dim=2,
        )
        if cfg.use_positional_embedding:
            n, seq_len = x.shape[2], self.pos_emb.shape[2]
            pos = self.pos_emb
            if n > seq_len:  # repeat-extension overflow path
                pos = pos.repeat(1, 1, n // seq_len + 1, 1)
            x = x + pos[:, :, :n]

        # window context parallelism: zero-pad the tokens to a shard multiple
        # and keep the padded keys out of every softmax; the padded rows are
        # never pooled (pooling reads the special tokens only)
        kv_valid = None
        if cfg.seq_shards > 1:
            true_len = x.shape[2]
            x = F.pad(x, (0, 0, 0, (-true_len) % cfg.seq_shards))
            kv_valid = torch.arange(x.shape[2], device=x.device) < true_len

        states = []
        for i in range(cfg.num_attn_layers):
            a = getattr(self, f"attn{i}")(getattr(self, f"attn{i}_norm")(x), generator=generator,
                                          kv_valid=kv_valid)
            x = x + dropout(a, light, generator)
            states.append(x)
            f = getattr(self, f"ffn{i}")(getattr(self, f"ffn{i}_norm")(x), generator)
            x = x + dropout(f, med, generator)
            if i > 0:
                cross = self.cross_scale_attn(x, states[-2], generator=generator,
                                              kv_valid=kv_valid)
                x = x + cfg.cross_scale_weight * cross

        combined = x[:, :, 0] + cfg.temporal_pool_weight * x[:, :, 1 : 1 + nt].mean(dim=2)
        return self._project([combined] * 3, generator)

    def _project(self, inputs, gen):
        outs = [
            dropout(gelu(getattr(self, f"multi_scale_proj{i}_ln")(
                getattr(self, f"multi_scale_proj{i}_fc")(inp))), 0.05, gen)
            for i, inp in enumerate(inputs)
        ]
        y = dropout(gelu(self.projection_ln1(self.projection_fc1(torch.cat(outs, dim=-1)))),
                    0.1, gen)
        final = self.projection_ln2(self.projection_fc2(y))
        div = self.diversity_head(final)
        div = div / (torch.linalg.vector_norm(div, dim=-1, keepdim=True) + 1e-12)
        return final + self.cfg.diversity_weight * div

    def _cnn_only_pool(self, x, gen):
        mean_pool = x.mean(dim=2)
        max_pool = x.amax(dim=2)
        attn_w = torch.softmax((x * mean_pool[:, :, None, :]).sum(dim=-1), dim=-1)
        attn_pool = (x * attn_w[..., None]).sum(dim=2)
        return self._project([mean_pool, max_pool, attn_pool], gen)

