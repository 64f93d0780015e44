"""Convert an HF ``BartForConditionalGeneration`` checkpoint (the reference
fine-tunes ``fnlp/bart-base-chinese``) into the port's BART decoder weights.

Port of ``imagined_speech_translation_tpu.cli.convert_hf``.  Input: a local
checkpoint directory holding ``model.safetensors`` or ``pytorch_model.bin``
(+ ``vocab.txt``).  Output: one ``torch.save`` file of the converted
``BartDecoderModel`` ``state_dict`` (the JAX script writes an orbax
directory), which ``cli.train --bart-params FILE`` grafts into the model::

    python -m imagined_speech_translation_tpu_torch.cli.convert_hf \\
        --checkpoint /path/to/fnlp-bart-base-chinese --out bart_params.pt \\
        [--vocab-size 51271]

``model.safetensors`` is read by this module's own reader, so the
``safetensors`` package is not needed.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import struct
from pathlib import Path

import numpy as np
import torch

from ..models.hf_convert import convert_hf_bart_state_dict

logger = logging.getLogger(__name__)

# safetensors dtype -> numpy dtype (little-endian); BF16, which numpy lacks,
# is read by torch
_NP_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U8": "u1", "BOOL": "?",
}


def read_safetensors(path: Path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors: an 8-byte little-endian header
    length, a JSON header of ``{name: {dtype, shape, data_offsets}}``, then
    the raw little-endian buffers."""
    data = bytearray(Path(path).read_bytes())
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape, dtype = info["shape"], info["dtype"]
        count = int(np.prod(shape, dtype=np.int64))
        if dtype == "BF16":
            t = (torch.frombuffer(data, dtype=torch.bfloat16, count=count, offset=base + begin)
                 if count else torch.empty(0, dtype=torch.bfloat16))
        elif dtype in _NP_DTYPES:
            t = torch.from_numpy(np.frombuffer(data, dtype=_NP_DTYPES[dtype], count=count,
                                               offset=base + begin))
        else:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dtype}")
        if t.numel() * t.element_size() != end - begin:
            raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, "
                             f"not {dtype} x {shape}")
        out[name] = t.reshape(shape)
    return out


def load_state_dict(checkpoint_dir: Path) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors, from ``model.safetensors`` or else
    ``pytorch_model.bin``, on the CPU."""
    st = Path(checkpoint_dir) / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bin_path = Path(checkpoint_dir) / "pytorch_model.bin"
    if bin_path.exists():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin under {checkpoint_dir}")


def infer_decoder_layers(sd: dict) -> int:
    layers = set()
    for k in sd:
        parts = k.split(".")
        if "decoder" in parts and "layers" in parts:
            layers.add(int(parts[parts.index("layers") + 1]))
    if not layers:
        raise ValueError("no decoder layers found in state dict")
    return max(layers) + 1


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True, help="the torch.save file to write")
    ap.add_argument("--vocab-size", type=int, default=None,
                    help="resize embeddings to this vocab (truncate, or append mean rows)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ckpt = Path(args.checkpoint)
    sd = load_state_dict(ckpt)
    n_layers = infer_decoder_layers(sd)
    logger.info("loaded %d tensors; %d decoder layers", len(sd), n_layers)
    params = convert_hf_bart_state_dict(sd, decoder_layers=n_layers,
                                        vocab_size=args.vocab_size)
    out = Path(args.out).absolute()
    out.parent.mkdir(parents=True, exist_ok=True)
    # one storage a tensor: a tensor read from a file is a view of its buffer
    torch.save({k: v.clone(memory_format=torch.contiguous_format)
                for k, v in params.items()}, out)
    logger.info("saved params to %s", out)
    vocab = ckpt / "vocab.txt"
    if vocab.exists():
        logger.info("tokenizer vocab available at %s", vocab)
    return str(out)


if __name__ == "__main__":
    main()
