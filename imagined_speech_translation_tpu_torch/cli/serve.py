"""The serving decode function: raw EEG windows -> text, on one CUDA device.

Port of ``imagined_speech_translation_tpu.cli.serve`` (``build_decode_fn``
and ``build_decode_fn_from_args``).  The decode function plugs into the
port's own ``runtime.batcher.BatchScheduler`` unchanged.  The port has no
``runtime.server`` yet; the websocket ``main``, the multi-device mesh and the
float16 wire option are not ported yet either.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path

import numpy as np
import torch

from ..config import Config, default_config, replace_nested

from ..data import ChineseCharTokenizer, RegionSpec, load_montage
from ..decode import DecodeParams, build_generate_fn
from ..frontend import SignalFrontend
from ..models import EEGDecodingModel, build_model, fold_batch_norm

logger = logging.getLogger(__name__)


def build_decode_fn(cfg: Config, tokenizer, region_spec, model: EEGDecodingModel, *,
                    device, fold_bn: bool = True, compute_dtype: torch.dtype | None = None):
    """``(N, n_ch, T)`` float32 numpy windows -> ``list[str]``.

    The IIR runs in float32 on the raw windows; with ``compute_dtype`` (e.g.
    ``torch.bfloat16``) the model's weights are cast after the float32
    BatchNorm fold and the activations after the IIR.  ``model`` itself is
    left unchanged."""
    device = torch.device(device)
    if fold_bn:
        model = fold_batch_norm(model)  # a folded copy, in float32
    elif compute_dtype is not None:
        model = copy.deepcopy(model)
    if compute_dtype is not None:
        model = model.to(compute_dtype)
    model = model.to(device).eval()
    frontend = SignalFrontend(cfg.frontend)
    dp = DecodeParams(
        max_length=cfg.generation.max_length,
        min_length=cfg.generation.min_length,
        num_beams=cfg.generation.num_beams,
        pad_token_id=tokenizer.pad_token_id,
        eos_token_id=tokenizer.sep_token_id,
        decoder_start_token_id=tokenizer.bos_token_id,
    )
    generate = build_generate_fn(model, dp)
    gather = torch.as_tensor(region_spec.gather_indices.reshape(-1), device=device)
    mask = torch.as_tensor(region_spec.channel_mask, device=device)
    R, C = mask.shape
    T = cfg.data.n_timepoints

    @torch.inference_mode()
    def decode_fn(windows: np.ndarray) -> list[str]:
        raw = torch.from_numpy(np.asarray(windows, np.float32)).to(device)
        clean = frontend.preprocess(raw)
        stacked = clean[:, gather, :].reshape(raw.shape[0], R, C, T)
        stacked = torch.where(mask[None, :, :, None], stacked, 0.0)
        if compute_dtype is not None:
            stacked = stacked.to(compute_dtype)
        tokens = generate(stacked, mask).cpu().numpy()
        return [t.strip() for t in tokenizer.batch_decode(tokens)]

    return decode_fn


def build_decode_fn_from_args(
    *,
    vocab: str,
    montage: str,
    config: str | None = None,
    checkpoint: str | None = None,
    random_init: bool = False,
    compute_dtype: str | None = None,
    max_batch: int = 1,
    device: str = "cuda",
):
    """Build and warm the serving ``decode_fn`` from plain arguments.

    ``checkpoint`` is a port ``state_dict`` saved with ``torch.save`` (e.g.
    from ``convert.convert_variables``); without it, or with ``random_init``,
    the weights are random from seed 0 (smoke mode)."""
    cfg = Config.from_json(Path(config).read_text()).validate() if config else default_config()
    tokenizer = ChineseCharTokenizer.from_vocab_file(vocab)
    if tokenizer.vocab_size != cfg.model.bart.vocab_size:
        cfg = replace_nested(cfg, "model.bart.vocab_size", tokenizer.vocab_size)
    spec = RegionSpec.from_channel_names(load_montage(montage))
    T = cfg.data.n_timepoints
    model = build_model(cfg.model, T, seed=0, device=device)
    if checkpoint and not random_init:
        model.load_state_dict(torch.load(checkpoint, map_location=device, weights_only=True))
        logger.info("loaded checkpoint %s", checkpoint)
    else:
        logger.warning("serving with random weights (smoke mode)")
    decode_fn = build_decode_fn(
        cfg, tokenizer, spec, model, device=device,
        compute_dtype=getattr(torch, compute_dtype) if compute_dtype else None,
    )
    n_ch = int(spec.gather_indices.max() + 1)
    logger.info("warming up the decode function...")
    decode_fn(np.zeros((max(1, max_batch), n_ch, T), np.float32))
    return decode_fn
