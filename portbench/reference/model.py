"""The plain reference of the EEG -> text model, in float32 PyTorch.

It follows the model as the configuration describes it (the port's
``config.py`` tree, handed in as a plain dict) and takes its weights as a
dict of tensors named as the port's ``state_dict`` names them, which the
benchmark makes from the seed.  It imports nothing of the port: every
layer is written out here with plain ``torch`` operations, and the
BatchNorm statistics are applied as they are handed in (the fold the
serving path makes is not used).

* The region encoders: the conv stem (BatchNorm, a depthwise stage,
  squeeze-excite), the token attention over the stem's tokens plus a CLS
  and the temporal tokens, the gated FFNs, the cross-scale attention after
  every layer but the first, the pooled projection and the diversity head.
* The fusion encoder: multi-scale convolutions over the region axis,
  region embeddings, the fusion layers, the gated cross-region attention,
  the region weighting and the enhancer; then ``eeg_to_bart``.
* The BART decoder, teacher-forced.  Its encoder is the projected feature
  tiled over ``encoder_layers`` positions, so cross-attention returns
  ``out_proj(v_proj(feature))`` at every query: that is how it is computed
  here (attention over identical keys is the identity on the values).

With a dropout generator (train mode) the reference draws its masks by the
port's published protocol (``ops/random.py``): one int32 seed per dropout
from the step's CPU generator, in the model's order; an elementwise or
small-attention mask is ``torch.bernoulli`` on a device generator seeded
with it, and a long unmasked attention's mask is the counter hash of
``csrc/dropout_mask.cuh`` (:mod:`.dropout`).  BatchNorm then normalises with
the batch's statistics.

``Precision(fp8=True)`` rounds both operands of every product (linear,
convolution, attention, the vocabulary head) to float8 e4m3 with a
per-tensor scale: the control that a lower precision must fail.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .dropout import attention_keep, bernoulli_keep

F8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Products in float32 proper: TF32 off for matrix products and
    convolutions while the block runs (a card rounds them to TF32
    otherwise)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Precision:
    """How the reference rounds the operands of its products: not at all
    (float32), or to float8 e4m3 with a per-tensor scale (the control);
    gradients pass the rounding unchanged."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return t
        with torch.no_grad():
            scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
            r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t).detach() if t.requires_grad else r


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def layer_norm(x, w, b, eps=1e-5):
    """LayerNorm over the last axis; ``w``/``b`` of shape ``(D,)`` or, for
    a region-stacked ``(R, ..., D)``, ``(R, D)``."""
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    if w.dim() == 2:
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return y * w.reshape(shape) + b.reshape(shape)
    return y * w + b


class Dropout:
    """The train-mode dropout stream: ``None`` generator means eval mode."""

    def __init__(self, generator: torch.Generator | None, mask_bytes: int):
        self.gen = generator
        self.mask_bytes = mask_bytes

    def __call__(self, x, rate):
        if self.gen is None or rate == 0.0:
            return x
        keep = bernoulli_keep(x.shape, 1.0 - rate, x.device, self.gen)
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))


class RefModel:
    """The model of the configuration ``cfg`` (the ``model`` and ``data``
    sections of the port's tree, as a plain dict) over the weights ``w``
    (port ``state_dict`` names without the ``model.`` prefix)."""

    def __init__(self, cfg: dict, w: dict, precision: Precision | None = None):
        self.cfg = cfg
        self.m = cfg["model"]
        self.be = self.m["brain_encoder"]
        self.re = self.be["region_encoder"]
        self.bart = self.m["bart"]
        self.w = w
        self.p = precision or Precision()

    # -- products -------------------------------------------------------
    def linear(self, x, name):
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        return torch.matmul(self.p(x), self.p(w).t()) + b

    def region_linear(self, x, name):
        """``(R, ..., in) -> (R, ..., out)`` with weight ``(R, out, in)``."""
        w, b = self.w[name + ".weight"], self.w[name + ".bias"]
        r, *mid, d = x.shape
        y = torch.bmm(self.p(x.reshape(r, -1, d)), self.p(w).transpose(1, 2)) + b[:, None, :]
        return y.reshape(r, *mid, y.shape[-1])

    def region_conv(self, x, name, groups_per_region=1):
        """Per-region conv on ``(B, R*C, T)``, stride 1, ``SAME`` padding."""
        w = self.w[name + ".weight"]
        b = self.w.get(name + ".bias")
        r, _, _, k = w.shape
        if k % 2 == 0:
            raise ValueError("the reference runs odd stem kernels only")
        return F.conv1d(self.p(x), self.p(w.flatten(0, 1)), None if b is None else b.flatten(),
                        padding=k // 2, groups=r * groups_per_region)

    def batch_norm(self, x, name, train):
        """Per-region BatchNorm on ``(B, R*C, T)``: running statistics in eval
        mode, the batch's (biased, over B and T) in train mode."""
        w, b = self.w[name + ".weight"].flatten(), self.w[name + ".bias"].flatten()
        if train:
            mean = x.mean(dim=(0, 2))
            var = ((x * x).mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
        else:
            mean = self.w[name + ".running_mean"].flatten()
            var = self.w[name + ".running_var"].flatten()
        return (x - mean[:, None]) * (torch.rsqrt(var + 1e-5) * w)[:, None] + b[:, None]

    def attention(self, q, k, v, heads, drop: Dropout, rate, causal=False):
        """Multi-head attention on head-split ``(N, H, S, d)`` tensors,
        softmax in float32.  A long unmasked attention draws the hashed
        tile mask, any other the Bernoulli one (the port's two routes)."""
        scale = q.shape[-1] ** -0.5
        logits = torch.matmul(self.p(q), self.p(k).transpose(-1, -2)) * scale
        if causal:
            s = logits.shape[-1]
            keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1)
        if drop.gen is not None and rate > 0.0:
            long = not causal and q.shape[-2] >= 128 and k.shape[-2] >= 128 and (
                q.shape[-1] <= 256)
            if long:
                keep = attention_keep(drop.gen, q.shape[0] * heads, heads, q.shape[-2],
                                      k.shape[-2], rate, drop.mask_bytes, q.device)
            else:
                keep = bernoulli_keep(probs.shape, 1.0 - rate, probs.device, drop.gen)
            probs = torch.where(keep, probs / (1.0 - rate), 0.0)
        return torch.matmul(self.p(probs), self.p(v))

    def mha(self, x, kv, name, heads, drop, rate, region=True):
        """Self- or cross-attention with q/k/v/out projections: ``(R, B, S,
        D)`` with per-region weights, or ``(B, S, D)``."""
        lin = self.region_linear if region else self.linear
        shape = x.shape
        d = shape[-1]

        def split(t):
            s = t.shape[-2]
            return t.reshape(-1, s, heads, d // heads).transpose(1, 2)

        q = split(lin(x, name + ".q_proj"))
        k = split(lin(kv, name + ".k_proj"))
        v = split(lin(kv, name + ".v_proj"))
        out = self.attention(q, k, v, heads, drop, rate)
        return lin(out.transpose(1, 2).reshape(shape), name + ".out_proj")

    # -- region encoders -------------------------------------------------
    def stem(self, x, drop, train):
        re, pre = self.re, "brain_encoder.region_encoders."
        light, med, heavy = re["dropout_tiers"]
        for i, _ in enumerate(re["conv_channels"]):
            if i == re["depthwise_stage"]:
                c_in = x.shape[1] // len(self.m["region_channel_counts"])
                y = self.region_conv(x, pre + f"stage{i}_depthwise", groups_per_region=c_in)
                y = self.region_conv(y, pre + f"stage{i}_pointwise")
                x = drop(gelu_tanh(self.batch_norm(y, pre + f"stage{i}_bn", train)), med)
                continue
            if pre + f"stage{i}_residual.conv.weight" in self.w:
                residual = self.batch_norm(self.region_conv(x, pre + f"stage{i}_residual.conv"),
                                           pre + f"stage{i}_residual.bn", train)
            else:
                residual = x
            y = self.batch_norm(self.region_conv(x, pre + f"stage{i}_convbn.conv"),
                                pre + f"stage{i}_convbn.bn", train)
            x = drop(gelu_tanh(y + residual), light if i < 2 else (med if i < 4 else heavy))
        # squeeze-excite
        b, rc, _ = x.shape
        r = len(self.m["region_channel_counts"])
        squeezed = x.mean(dim=-1).reshape(b, r, -1).transpose(0, 1)
        e = torch.relu(self.region_linear(squeezed, pre + "se.fc1"))
        e = torch.sigmoid(self.region_linear(e, pre + "se.fc2"))
        return drop(x * e.transpose(0, 1).reshape(b, rc, 1), heavy)

    def region_encoders(self, x, drop, train):
        """``(B, R, C, T)`` -> ``(R, B, hidden)``."""
        re, pre = self.re, "brain_encoder.region_encoders."
        b, r, c, t = x.shape
        h = self.be["hidden_dim"]
        x = self.stem(x.reshape(b, r * c, t), drop, train)
        x = x.reshape(b, r, -1, x.shape[-1]).permute(1, 0, 3, 2)  # (R, B, T, C)
        light, med, _ = re["dropout_tiers"]
        y = drop(gelu_tanh(layer_norm(self.region_linear(x, pre + "cnn_to_attn_fc1"),
                                      self.w[pre + "cnn_to_attn_ln1.weight"],
                                      self.w[pre + "cnn_to_attn_ln1.bias"])), 0.1)
        y = drop(gelu_tanh(layer_norm(self.region_linear(y, pre + "cnn_to_attn_fc2"),
                                      self.w[pre + "cnn_to_attn_ln2.weight"],
                                      self.w[pre + "cnn_to_attn_ln2.bias"])), 0.05)
        x = self.region_linear(y, pre + "cnn_to_attn_fc3")
        nt = re["num_temporal_tokens"]
        x = torch.cat([self.w[pre + "cls_token"].expand(r, b, 1, h),
                       self.w[pre + "temporal_tokens"].expand(r, b, nt, h), x], dim=2)
        if re["use_positional_embedding"]:
            x = x + self.w[pre + "pos_emb"][:, :, : x.shape[2]]
        states = []
        for i in range(re["num_attn_layers"]):
            n = layer_norm(x, self.w[pre + f"attn{i}_norm.weight"],
                           self.w[pre + f"attn{i}_norm.bias"])
            a = self.mha(n, n, pre + f"attn{i}", re["attn_heads"][i], drop, 0.1)
            x = x + drop(a, light)
            states.append(x)
            n = layer_norm(x, self.w[pre + f"ffn{i}_norm.weight"],
                           self.w[pre + f"ffn{i}_norm.bias"])
            g = gelu_tanh(self.region_linear(n, pre + f"ffn{i}.linear1")) * torch.sigmoid(
                self.region_linear(n, pre + f"ffn{i}.gate"))
            f = self.region_linear(drop(g, 0.1), pre + f"ffn{i}.linear2")
            x = x + drop(f, med)
            if i > 0:
                cross = self.mha(x, states[-2], pre + "cross_scale_attn",
                                 re["attn_heads"][0] // 2, drop, 0.1)
                x = x + re["cross_scale_weight"] * cross
        combined = x[:, :, 0] + re["temporal_pool_weight"] * x[:, :, 1: 1 + nt].mean(dim=2)
        outs = [drop(gelu_tanh(layer_norm(
            self.region_linear(combined, pre + f"multi_scale_proj{i}_fc"),
            self.w[pre + f"multi_scale_proj{i}_ln.weight"],
            self.w[pre + f"multi_scale_proj{i}_ln.bias"])), 0.05) for i in range(3)]
        y = drop(gelu_tanh(layer_norm(self.region_linear(torch.cat(outs, -1),
                                                         pre + "projection_fc1"),
                                      self.w[pre + "projection_ln1.weight"],
                                      self.w[pre + "projection_ln1.bias"])), 0.1)
        final = layer_norm(self.region_linear(y, pre + "projection_fc2"),
                           self.w[pre + "projection_ln2.weight"],
                           self.w[pre + "projection_ln2.bias"])
        div = self.region_linear(final, pre + "diversity_head")
        div = div / (torch.linalg.vector_norm(div, dim=-1, keepdim=True) + 1e-12)
        return final + re["diversity_weight"] * div

    # -- fusion -----------------------------------------------------------
    def enhancer(self, x, drop):
        pre = "brain_encoder.feature_enhancer."
        y = drop(gelu_tanh(self.linear(x, pre + "fc1")), 0.1)
        return layer_norm(self.linear(y, pre + "fc2"), self.w[pre + "ln.weight"],
                          self.w[pre + "ln.bias"])

    def brain_encoder(self, eeg, channel_mask, drop, train):
        be, pre = self.be, "brain_encoder."
        eeg = torch.where(channel_mask[None, :, :, None], eeg, 0.0)
        feats = self.region_encoders(eeg, drop, train).transpose(0, 1)  # (B, R, h)
        fr = feats.transpose(1, 2)
        ms = []
        for k in be["multi_scale_kernels"]:
            w = self.w[pre + f"temporal_scale_k{k}.weight"]
            y = F.conv1d(self.p(fr), self.p(w), self.w[pre + f"temporal_scale_k{k}.bias"],
                         padding=k // 2)
            ms.append(gelu_tanh(y).mean(dim=-1))
        y = drop(gelu_tanh(self.linear(torch.cat(ms, -1), pre + "diversity_projection_fc1")),
                 0.1)
        y = layer_norm(self.linear(y, pre + "diversity_projection_fc2"),
                       self.w[pre + "diversity_projection_ln.weight"],
                       self.w[pre + "diversity_projection_ln.bias"])
        x = feats + be["multi_scale_weight"] * y[:, None, :]
        x = x + be["region_embed_weight"] * self.w[pre + "region_embeddings"][None]
        if not be["disable_cross_region_attn"]:
            for i in range(be["fusion_layers"]):
                lp = pre + f"fusion_layer{i}."
                n = layer_norm(x, self.w[lp + "norm1.weight"], self.w[lp + "norm1.bias"])
                x = x + drop(self.mha(n, n, lp + "attn", be["fusion_heads"], drop, 0.1,
                                      region=False), 0.1)
                n = layer_norm(x, self.w[lp + "norm2.weight"], self.w[lp + "norm2.bias"])
                f = drop(gelu_tanh(self.linear(n, lp + "ffn_fc1")), 0.1)
                x = x + drop(self.linear(f, lp + "ffn_fc2"), 0.1)
            cross = self.mha(x, x, pre + "cross_region_attention", be["cross_region_heads"],
                             drop, 0.1, region=False)
            gate = torch.sigmoid(self.enhancer(x.mean(dim=1), drop))
            x = x + gate[:, None, :] * cross
        if be["uniform_region_weight"]:
            fused = x.mean(dim=1)
        else:
            g = drop(gelu_tanh(self.linear(x.mean(dim=1), pre + "region_gate_fc1")), 0.1)
            dynamic = torch.sigmoid(self.linear(g, pre + "region_gate_fc2"))
            static = torch.softmax(self.w[pre + "region_importance"], dim=0)
            frac = be["static_weight_frac"]
            combined = torch.softmax(frac * static[None] + (1.0 - frac) * dynamic, dim=1)
            fused = (x * combined[..., None]).sum(dim=1)
        return fused + be["enhancer_weight"] * self.enhancer(fused, drop)

    def encode(self, eeg, channel_mask, drop=None, train=False):
        """``(B, R, C, T)`` float32 EEG -> (fused feature ``(B, h)``,
        projected feature ``(B, d)`` that the decoder's cross-attention
        reads at every position)."""
        drop = drop or Dropout(None, 2)
        feat = self.brain_encoder(eeg, channel_mask, drop, train)
        proj = layer_norm(self.linear(feat, "eeg_to_bart_fc"), self.w["eeg_to_bart_ln.weight"],
                          self.w["eeg_to_bart_ln.bias"], eps=1e-6)
        return feat, proj

    # -- decoder ------------------------------------------------------------
    def decode(self, ids, proj, drop=None, return_hidden=False):
        """Teacher-forced logits ``(B, L, V)`` for decoder inputs ``ids``
        ``(B, L)`` given the projected feature ``(B, d)``."""
        cfg, pre = self.bart, "bart."
        drop = drop or Dropout(None, 2)
        b, length = ids.shape
        heads = cfg["num_heads"]
        x = self.w[pre + "shared.weight"][ids]
        if cfg["scale_embedding"]:
            x = x * math.sqrt(cfg["d_model"])
        pos = torch.arange(length, device=ids.device) + cfg["position_offset"]
        x = layer_norm(x + self.w[pre + "embed_positions"][pos],
                       self.w[pre + "layernorm_embedding.weight"],
                       self.w[pre + "layernorm_embedding.bias"])
        x = drop(x, cfg["dropout"])
        d = cfg["d_model"]
        for li in range(cfg["decoder_layers"]):
            lp = pre + f"layer{li}."

            def split(t):
                return t.reshape(b, -1, heads, d // heads).transpose(1, 2)

            q = split(self.linear(x, lp + "self_attn.q_proj"))
            k = split(self.linear(x, lp + "self_attn.k_proj"))
            v = split(self.linear(x, lp + "self_attn.v_proj"))
            a = self.attention(q, k, v, heads, drop, cfg["attention_dropout"], causal=True)
            a = self.linear(a.transpose(1, 2).reshape(b, length, d), lp + "self_attn.out_proj")
            x = layer_norm(x + drop(a, cfg["dropout"]), self.w[lp + "self_attn_layer_norm.weight"],
                           self.w[lp + "self_attn_layer_norm.bias"])
            cross = self.linear(self.linear(proj, lp + "encoder_attn.v_proj"),
                                lp + "encoder_attn.out_proj")
            x = layer_norm(x + drop(cross[:, None, :].expand_as(x), cfg["dropout"]),
                           self.w[lp + "encoder_attn_layer_norm.weight"],
                           self.w[lp + "encoder_attn_layer_norm.bias"])
            h = F.gelu(self.linear(x, lp + "fc1"))  # exact erf GELU, as BART's
            f = self.linear(drop(h, cfg["dropout"]), lp + "fc2")
            x = layer_norm(x + drop(f, cfg["dropout"]), self.w[lp + "final_layer_norm.weight"],
                           self.w[lp + "final_layer_norm.bias"])
        logits = torch.matmul(self.p(x), self.p(self.w[pre + "shared.weight"]).t())
        if cfg["tie_word_embeddings"]:
            logits = logits + self.w[pre + "final_logits_bias"]
        return (logits, x) if return_hidden else logits
