"""Graft converted pretrained BART weights into a fresh train state.

Port of ``imagined_speech_translation_tpu.training.pretrained``.  The
reference fine-tunes ``fnlp/bart-base-chinese`` rather than training the
decoder from scratch; ``cli/convert_hf.py`` converts the HF checkpoint into a
``torch.save`` file of the port's ``BartDecoderModel`` ``state_dict``, and
this module copies it into ``state.module.model.bart``:

* the key set must match exactly (the converter is parity-tested);
* a tensor of the same shape is copied; one whose trailing shape matches but
  whose leading axis does not (the vocabulary rows, but also a longer
  ``embed_positions`` or any 1-D tensor) has its overlapping rows copied and
  keeps the fresh values of the rest, the reference's
  ``resize_token_embeddings`` semantics; any other shape raises;
* values are cast to the parameter's dtype (float32 master weights) and
  copied in place, into the parameters the optimizer and the train step
  already hold;
* in a tensor-parallel state each rank copies its slice of every split
  tensor, which must have the single-device shape.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


def _splice(old: torch.Tensor, new: torch.Tensor, path: str) -> None:
    """Copy ``new`` into ``old`` in place (see the module docstring)."""
    if new.shape == old.shape:
        old.copy_(new)
    elif new.dim() >= 1 and new.shape[1:] == old.shape[1:]:
        n = min(new.shape[0], old.shape[0])
        old[:n].copy_(new[:n])
        logger.warning("%s: vocab rows %d -> %d (overlap-copied %d)",
                       path, new.shape[0], old.shape[0], n)
    else:
        raise ValueError(f"pretrained leaf {path} has shape {tuple(new.shape)}, "
                         f"model expects {tuple(old.shape)}")


@torch.no_grad()
def graft_bart_params(state, path: str | Path):
    """Copy the converted checkpoint at ``path`` (a file written by
    ``cli.convert_hf``) into ``state``'s BART decoder, in place; returns
    ``state``."""
    restored = torch.load(Path(path), map_location="cpu", weights_only=True)
    bart = state.module.model.bart
    params = dict(bart.named_parameters())
    if set(params) != set(restored):
        missing = sorted(set(params) - set(restored))
        extra = sorted(set(restored) - set(params))
        raise ValueError(
            "converted BART tree does not match the model: "
            f"missing={missing[:5]} extra={extra[:5]}")
    tp = getattr(state, "tensor_parallel", None)
    for name, p in params.items():
        new, key = restored[name], "model.bart." + name
        if tp is not None and key in tp.dims:
            whole = list(p.shape)
            whole[tp.dims[key]] *= tp.world
            if list(new.shape) != whole:
                raise ValueError(f"pretrained leaf {name} has shape {tuple(new.shape)}; a "
                                 f"tensor-parallel graft expects {tuple(whole)}")
            new = tp.local(key, new)
        _splice(p, new.to(p.device, p.dtype), name)
    logger.info("grafted %d pretrained BART leaves from %s", len(params), path)
    return state
