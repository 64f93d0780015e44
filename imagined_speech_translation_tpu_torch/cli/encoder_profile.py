"""Encoder-internal segment profiler on one CUDA card: where the batch-16
region-encoder forward goes.

Port of ``tools/encoder_profile.py``.  Method: program subtraction over
configuration ablations of the port's real ``BrainRegionEncoder``; each
program is the full forward with stages removed, so a segment's cost is a
difference of medians:

* ``stem``         — ``cnn_only=True``: conv stem + SE + the cnn-only pooling;
* ``layers1``      — ``num_attn_layers=1`` (``attn_heads[:1]``): adds the
  cnn->attn MLP, the CLS and temporal tokens, positions, one attention + FFN
  layer, the pooling and projections;
* ``layers2``      — ``num_attn_layers=2`` (``attn_heads[:2]``): adds a layer
  and the cross-scale attention;
* ``full``         — the configured encoder;
* ``regions_only`` — the four region encoders alone behind the channel mask
  (:class:`RegionsOnly`), so ``full - regions_only`` is the fusion stage:
  multi-scale region convs, fusion layers, cross-region attention, region
  weighting and the enhancer.

Each encoder has random weights from seed 0, BatchNorm folded
(``models.fold_batch_norm``) and is cast to bf16; the input is normal EEG
``(BATCH, 4, 16, T)`` made with numpy.  One encoder is built, timed and
freed before the next.  A program is the median wall time of ``ITERS``
forwards after a warm-up, on the host clock between two synchronizes
(``roundtrip_ms`` is the cost of an empty synchronize, reported and not
subtracted).  Beside it the report gives the busy device milliseconds and
kernel launches of one profiled forward (``device_ms``, ``launches``), the
port's kernel launches by name (``kernel_launches``: the flash forward
launches ``2 * num_attn_layers - 1`` times a forward, none under
``cnn_only``) and the peak device memory of each program.

``analytic_tflop_per_fwd`` is the JAX tool's FLOP count, kept unchanged so
the two reports agree: the region encoders' QKV/O projections, scores and
PV, gated FFNs, stem and MLP, four regions, the whole batch.  It leaves out
the cross-scale attention and the fusion stage.  ``effective_tflops`` is that
count over ``full_ms``, and ``peak_share`` its share of the card's 989
TFLOP/s dense bf16 peak.

Knobs, as the JAX tool's (environment variables)::

    python -m imagined_speech_translation_tpu_torch.cli.encoder_profile
    BATCH=16 ITERS=8 python -m imagined_speech_translation_tpu_torch.cli.encoder_profile
    HIDDEN=64 python -m imagined_speech_translation_tpu_torch.cli.encoder_profile --device cpu

``--device`` (``cuda`` by default) replaces ``PROFILE_FORCE_PLATFORM``.
Writes ``runs/torch_profile/encoder_segments.json``; the first printed line
is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..config import BrainEncoderConfig, Config, default_config
from ..models import fold_batch_norm
from ..models.brain_encoder import BrainRegionEncoder
from ..models.init import init_parameters
from ..models.layers import RegionConvAttentionEncoder
from .profile_slice import (
    by_program,
    channel_mask,
    open_device,
    peak_memory_gib,
    reset_peak_memory,
    roundtrip_ms,
    time_program,
    write_report,
)

PROGRAMS = ("full", "layers2", "layers1", "stem", "regions_only")
PEAK_BF16_TFLOPS = 989.0  # H100 SXM dense bf16
DEFAULT_OUT = Path("runs/torch_profile/encoder_segments.json")


class RegionsOnly(nn.Module):
    """The brain encoder's four region encoders alone: ``(B, R, C, T)`` EEG
    behind the ``(R, C)`` channel mask -> ``(B, R, hidden_dim)``."""

    def __init__(self, cfg: BrainEncoderConfig, *, in_channels: int, n_timepoints: int,
                 n_regions: int = 4):
        super().__init__()
        self.region_encoders = RegionConvAttentionEncoder(
            cfg.region_encoder, cfg.hidden_dim, n_regions=n_regions, in_channels=in_channels,
            n_timepoints=n_timepoints,
        )

    def forward(self, eeg, channel_mask):
        mask = torch.as_tensor(channel_mask, device=eeg.device)
        x = torch.where(mask[None, :, :, None], eeg, 0.0)
        return self.region_encoders(x).transpose(0, 1)


def hidden_override(be: BrainEncoderConfig, h: int) -> BrainEncoderConfig:
    """The JAX tool's ``HIDDEN`` configuration: width ``h``, 4 fusion and
    cross-region heads, conv widths scaled from 768, heads (4, 2, 2), SE
    reduction 4."""
    return dataclasses.replace(
        be, hidden_dim=h, fusion_heads=4, cross_region_heads=4,
        region_encoder=dataclasses.replace(
            be.region_encoder,
            conv_channels=tuple(max(8, h * f // 768) for f in (128, 256, 384, 512, 768)),
            attn_heads=(4, 2, 2), se_reduction=4,
        ),
    )


def program_configs(be: BrainEncoderConfig) -> dict[str, BrainEncoderConfig]:
    """The encoder configuration of each program (``regions_only`` uses the
    full one's region encoders)."""
    re_cfg = be.region_encoder

    def layers(n):
        return dataclasses.replace(be, region_encoder=dataclasses.replace(
            re_cfg, num_attn_layers=n, attn_heads=re_cfg.attn_heads[:n]))

    return {
        "full": be, "layers2": layers(2), "layers1": layers(1),
        "stem": dataclasses.replace(be, region_encoder=dataclasses.replace(re_cfg, cnn_only=True)),
        "regions_only": be,
    }


def flash_launches(be: BrainEncoderConfig) -> int:
    """Flash forward launches of one forward: each attention layer, and the
    cross-scale attention after every layer but the first."""
    re_cfg = be.region_encoder
    return 0 if re_cfg.cnn_only else 2 * re_cfg.num_attn_layers - 1


def encoder_module(name: str, be: BrainEncoderConfig, cfg: Config, T: int) -> nn.Module:
    """Program ``name``'s module, float32, parameters unset (on the meta
    device under ``torch.device("meta")``)."""
    kw = dict(in_channels=cfg.model.max_region_channels, n_timepoints=T,
              n_regions=len(cfg.model.region_channel_counts))
    cls = RegionsOnly if name == "regions_only" else BrainRegionEncoder
    return cls(program_configs(be)[name], **kw)


def prepare(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """The served form of ``module``: BatchNorm folded, cast, eval mode."""
    return fold_batch_norm(module).to(dtype).eval()


def analytic_flops(be: BrainEncoderConfig, T: int, B: int) -> float:
    """The JAX tool's bf16 FLOP count of a full encoder forward (MACs x 2)."""
    h = be.hidden_dim
    chans = [16] + list(be.region_encoder.conv_channels)
    kerns = be.region_encoder.conv_kernels
    stem = sum(k * cin * cout for k, cin, cout in zip(kerns, chans[:-1], chans[1:])) * T * 2
    S = T + 4
    mlp = S * (h * 2 * h + 2 * h * h + h * h) * 2
    per_layer = (
        4 * S * h * h * 2          # qkvo projections
        + 2 * S * S * h * 2        # scores + weighted V
        + S * (h * 4 * h * 2 + h * 4 * h) * 2  # gated FFN (first layer 4h)
    )
    return (stem + mlp + 3 * per_layer) * 4 * B


def run(cfg: Config, device, *, batch: int, iters: int, T: int | None = None,
        be: BrainEncoderConfig | None = None, smi: str = "cpu") -> dict:
    """The report at ``cfg`` (its brain encoder, or ``be``) on ``device``."""
    device = torch.device(device)
    be = be or cfg.model.brain_encoder
    T = T or cfg.data.n_timepoints
    rng = np.random.default_rng(0)
    eeg = torch.from_numpy(rng.normal(size=(batch, 4, 16, T)).astype(np.float32))
    eeg = eeg.to(device, torch.bfloat16)
    mask = channel_mask(cfg, device)
    report = {"batch": batch, "timepoints": T, "iters": iters, "platform": device.type,
              "roundtrip_ms": roundtrip_ms(device, iters)}
    profs, peaks = {}, {}
    for name in PROGRAMS:
        reset_peak_memory(device)
        with torch.device("meta"):
            module = encoder_module(name, be, cfg, T)
        model = prepare(init_parameters(module.to_empty(device=device), 0))
        forward = torch.inference_mode()(lambda: model(eeg, mask))
        report[f"{name}_ms"], profs[name] = time_program(f"{name}_ms", forward, device, iters)
        peaks[name] = peak_memory_gib(device)
        del module, model, forward
        if device.type == "cuda":
            torch.cuda.empty_cache()
    report["derived"] = {
        "attn_layer3_marginal_ms": report["full_ms"] - report["layers2_ms"],
        "attn_layer2_marginal_ms": report["layers2_ms"] - report["layers1_ms"],
        "mlp_tokens_layer1_ms": report["layers1_ms"] - report["stem_ms"],
        "fusion_ms": report["full_ms"] - report["regions_only_ms"],
    }
    total = analytic_flops(be, T, batch)
    report["analytic_tflop_per_fwd"] = total / 1e12
    report["effective_tflops"] = total / 1e12 / (report["full_ms"] / 1e3)
    report["peak_share"] = report["effective_tflops"] / PEAK_BF16_TFLOPS
    report.update(by_program(profs), peak_memory_gib=peaks, card=smi)
    return report


def main(argv=None, *, cfg: Config | None = None) -> int:
    """The CLI; ``cfg`` replaces ``default_config()`` (the tests' tiny one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device, smi = open_device(args.device)
    cfg = cfg or default_config()
    be = cfg.model.brain_encoder
    if os.environ.get("HIDDEN"):  # a small run of the harness itself
        be = hidden_override(be, int(os.environ["HIDDEN"]))
    report = run(cfg, device, batch=int(os.environ.get("BATCH", "16")),
                 iters=int(os.environ.get("ITERS", "8")),
                 T=int(os.environ.get("T", str(cfg.data.n_timepoints))), be=be, smi=smi)
    write_report(report, DEFAULT_OUT)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
