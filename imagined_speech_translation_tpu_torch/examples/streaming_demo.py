"""Streaming end-to-end demo: a synthetic EEG device stream -> wake gate ->
windowed preprocess -> beam decode -> text, with latency stats.

Port of ``examples/streaming_demo.py``.  Runs in one process with a tiny
model (random weights from seed 0, or ``state_dict``), no downloads; the
product path of SURVEY.md §3.5 on ``--device`` (the card by default).
``--source device`` streams from the port's acquisition-board twin
(``device.NativeBoard``, the 6x ADS1299 firmware of ``device_native/``,
built by the host C++ compiler into ``build/native/``) instead of numpy
noise.

    python -m imagined_speech_translation_tpu_torch.examples.streaming_demo \\
        [--device cpu] [--chunks 12] [--source noise|device]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

T = 256
VOCAB = list(dict.fromkeys(
    ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", "[EOS]"]
    + list("我想喝水请帮打开窗户今天气很好")
))


def demo_tokenizer():
    from ..data import ChineseCharTokenizer

    return ChineseCharTokenizer(VOCAB, eos_token="[EOS]")


def demo_config(tok):
    """The JAX demo's config: T = 256, hidden 64, 3 + 2 BART layers."""
    from ..config import (
        BartConfig,
        BrainEncoderConfig,
        Config,
        DataConfig,
        FrontendConfig,
        ModelConfig,
        RegionEncoderConfig,
    )

    h = 64
    return Config(
        data=DataConfig(n_timepoints=T, max_length=12),
        frontend=FrontendConfig(stft_nperseg=64, stft_hop=32),
        model=ModelConfig(
            hidden_dim=h,
            brain_encoder=BrainEncoderConfig(
                hidden_dim=h, fusion_heads=4, cross_region_heads=4,
                region_encoder=RegionEncoderConfig(
                    conv_channels=(16, 24, 32, 48, 64), attn_heads=(4, 2, 2),
                    se_reduction=4,
                ),
            ),
            bart=BartConfig(
                vocab_size=tok.vocab_size, d_model=h, encoder_layers=3,
                decoder_layers=2, num_heads=4, ffn_dim=128,
                max_position_embeddings=32, pad_token_id=tok.pad_token_id,
                bos_token_id=tok.bos_token_id, eos_token_id=tok.sep_token_id,
                decoder_start_token_id=tok.bos_token_id,
            ),
        ),
    ).validate()


def demo_spec(source: str):
    """The region spec: the board twin exposes exactly the 48 electrode
    channels, so its montage has no filler rows; the noise source mimics
    the Chisco 125-row layout (48 mapped, interleaved)."""
    from ..data import RegionSpec
    from ..data.synthetic import make_synthetic_montage

    with tempfile.TemporaryDirectory() as d:
        labels = make_synthetic_montage(Path(d) / "m.csv", 48 if source == "device" else 125)
    return RegionSpec.from_channel_names(labels)


def build_demo_decode_fn(cfg, tok, spec, *, device: str = "cuda", state_dict=None,
                         fold_bn: bool = True):
    """``cli.serve.build_decode_fn`` over the demo's model (float32): random
    weights from seed 0, or ``state_dict`` loaded strictly."""
    import torch

    from ..cli.serve import build_decode_fn
    from ..models import build_model

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run the demo on the CPU")
    model = build_model(cfg.model, cfg.data.n_timepoints, seed=0, device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return build_decode_fn(cfg, tok, spec, model, device=device, fold_bn=fold_bn)


def chunk_source(source: str, n_ch: int, chunks: int):
    """The demo's stream: ``chunks`` chunks of ``(n_ch, T // 4)`` float32
    samples, every fourth near-silent (gated out).  From numpy noise (seed 0)
    or, for ``device``, from a board twin (noise seed 7, 5 uV; zeros fed at
    the electrodes for the quiet chunks; uV scaled by 1/100)."""
    board = None
    if source == "device":
        from ..device import NativeBoard

        board = NativeBoard(data_rate_sps=500, noise_seed=7, noise_uv=5.0)
        board.bring_up()
        print(f"device twin up: {board.n_channels}ch @ {board.data_rate_sps} SPS "
              "(6x ADS1299, gain 24)")
    rng = np.random.default_rng(0)
    try:
        for chunk in range(chunks):
            quiet = chunk % 4 == 3  # alternate quiet (gated out) and active segments
            if board is not None:
                if quiet:  # near-silence at the electrodes
                    board.feed(np.zeros((48, T // 4), np.float32))
                board.pump(T // 4)
                yield board.drain(T // 4) / 100.0  # uV -> the model's input scale
            else:
                scale = 0.001 if quiet else 1.0
                yield (rng.normal(size=(n_ch, T // 4)) * scale).astype(np.float32)
    finally:
        if board is not None:
            board.close()


def run(*, source: str = "noise", chunks: int = 12, device: str = "cuda", state_dict=None,
        fold_bn: bool = True) -> dict:
    """Stream the chunks through a ``DecodePipeline``; returns the
    utterances, the chunks fed and the latency summary."""
    from ..runtime import DecodePipeline, RingBuffer, ThresholdWakeGate, Windower
    from ..utils.cache import enable_persistent_cache

    enable_persistent_cache()
    tok = demo_tokenizer()
    cfg = demo_config(tok)
    spec = demo_spec(source)
    n_ch = int(spec.gather_indices.max() + 1)
    decode_fn = build_demo_decode_fn(cfg, tok, spec, device=device, state_dict=state_dict,
                                     fold_bn=fold_bn)

    print("warming up the decode function (the first call builds the kernels)...")
    t0 = time.time()
    decode_fn(np.zeros((1, n_ch, T), np.float32))
    print(f"  ready in {time.time() - t0:.1f}s")

    ring = RingBuffer(n_ch, capacity=4 * T)
    pipe = DecodePipeline(
        windower=Windower(ring, window=T, hop=T),
        decode_fn=decode_fn,
        wake_gate=ThresholdWakeGate(0.05),
        max_batch=1,
    )
    print(f"streaming {chunks} chunks of ({n_ch}ch x {T // 4} samples)...")
    t0 = time.time()
    utterances, fed = [], []
    for samples in chunk_source(source, n_ch, chunks):
        fed.append(samples)
        for text in pipe.feed(samples):
            utterances.append(text)
            print(f"  [{time.time() - t0:6.2f}s] utterance: {text!r}")
    for text in pipe.flush():
        utterances.append(text)
        print(f"  [{time.time() - t0:6.2f}s] utterance (flush): {text!r}")

    stats = pipe.latency.summary()
    print(f"\ndecoded {len(utterances)} utterances")
    print(f"latency p50={stats['p50_ms']:.1f}ms p95={stats['p95_ms']:.1f}ms "
          f"mean={stats['mean_ms']:.1f}ms (n={stats['count']})")
    return {"utterances": utterances, "chunks": fed, "latency": stats, "n_channels": n_ch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--chunks", type=int, default=12)
    ap.add_argument("--source", choices=("noise", "device"), default="noise",
                    help="'device' streams from the native 6x-ADS1299 firmware twin "
                    "(device_native/) instead of host-side numpy noise")
    args = ap.parse_args(argv)
    run(source=args.source, chunks=args.chunks, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
