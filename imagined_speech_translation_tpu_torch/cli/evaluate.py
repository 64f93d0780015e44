"""Evaluation of a saved checkpoint on a dataset split.

Port of ``imagined_speech_translation_tpu.cli.evaluate``::

    python -m imagined_speech_translation_tpu_torch.cli.evaluate \\
        --data-dir ... --montage ... --vocab ... \\
        --checkpoint runs/latest/checkpoints/best_model [--split test]

It prints the metrics as one JSON line, as the JAX script does.  The BoW
loss's token ids come from the training split's texts, as ``cli.train``
picks them, so the losses equal the trainer's own evaluation of the same
weights (the JAX script takes the vocabulary's first ids instead, and its
``loss_bow`` and ``val_loss`` differ from its trainer's).  It runs on the
CUDA card, or on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from ..config import replace_nested
from ..data import ChineseCharTokenizer, EEGTextDataset, split_indices
from ..training import EEGTrainer
from ..utils.cache import enable_persistent_cache
from .train import check_device, corpus_bow_indices, load_config

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--montage", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--vocab", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides")
    ap.add_argument("--split", choices=("val", "test", "train"), default="test")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = check_device(args.device)
    enable_persistent_cache()

    cfg = load_config(args.config, args.overrides)
    tokenizer = ChineseCharTokenizer.from_vocab_file(args.vocab)
    if tokenizer.vocab_size != cfg.model.bart.vocab_size:
        cfg = replace_nested(cfg, "model.bart.vocab_size", tokenizer.vocab_size)
    dataset = EEGTextDataset(
        args.data_dir, args.montage, tokenizer, cfg.data, augment=False,
        seed=cfg.training.seed,
    )
    tr, va, te = split_indices(
        len(dataset),
        (cfg.data.train_split, cfg.data.val_split, cfg.data.test_split),
        cfg.training.seed,
    )
    eval_idx = {"train": tr, "val": va, "test": te}[args.split]
    bow = corpus_bow_indices(dataset, tr, tokenizer, cfg.training.loss.bow_vocab_size)

    ckpt_path = Path(args.checkpoint)
    trainer = EEGTrainer(
        cfg, dataset, tokenizer, bow_indices=bow,
        train_indices=tr, val_indices=eval_idx,
        checkpoint_dir=str(ckpt_path.parent), device=device,
    )
    state = trainer.init_state(cfg.training.seed)
    state, meta = trainer.ckpt.restore(ckpt_path.name, state)
    logger.info("restored %s (epoch %s)", ckpt_path.name, meta.get("epoch"))

    metrics = trainer.evaluate(state)
    printable = {
        k: v for k, v in metrics.items() if not isinstance(v, (list, tuple))
    }
    print(json.dumps(printable, default=float))
    for pred, tgt in zip(metrics["predictions"][:5], metrics["targets"][:5]):
        logger.info("target: %s | pred: %s", tgt, pred)
    return metrics


if __name__ == "__main__":
    main()
