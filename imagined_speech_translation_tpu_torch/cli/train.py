"""End-to-end training script.

Port of ``imagined_speech_translation_tpu.cli.train``.  Flow: config (JSON
plus dotted-path overrides) -> seed -> tokenizer -> dataset and splits ->
BoW indices -> trainer -> train -> final test evaluation; every stage
resumes with ``--resume``::

    python -m imagined_speech_translation_tpu_torch.cli.train \\
        --data-dir data/eeg_data --montage data/montage.csv \\
        --vocab vocab.txt [--config cfg.json] [--set training.seed=7] \\
        [--bart-params bart_params.pt] ...

``--bart-params FILE`` reads the file that ``cli.convert_hf`` writes (the
converted HF BART decoder, e.g. ``fnlp/bart-base-chinese``, the reference's
fine-tune setup) and grafts it into the fresh state's decoder in place
(``training.pretrained.graft_bart_params``), before ``--resume``, so a
resumed checkpoint overrides it.  It trains on the CUDA card, or on the CPU
with ``--device cpu``; it never falls back from one to the other.  The JAX
script's persistent compile cache is not ported.

Data parallelism: start one process a rank with ``IST_COORDINATOR=host:port``,
``IST_NUM_PROCESSES=N`` and ``IST_PROCESS_ID=i`` (optionally
``IST_BACKEND=gloo``; see ``parallel.distributed``) and the same flags plus
``--set parallel.data_axis=N`` (or ``parallel.dcn_axis``).  Rank ``i`` trains
on ``cuda:{i % device_count}`` (``--device cpu``: CPU ranks on gloo); the
primary logs the metrics and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch

from ..config import Config, default_config, replace_nested
from ..data import ChineseCharTokenizer, EEGTextDataset, split_indices
from ..parallel import initialize_distributed, is_primary
from ..parallel.distributed import rank_device
from ..training import EEGTrainer, get_top_k_vocab_indices
from ..training.pretrained import graft_bart_params
from ..utils import seed_everything
from ..utils.metrics import NullLogger, get_logger

logger = logging.getLogger(__name__)


def parse_override(cfg: Config, expr: str) -> Config:
    path, _, raw = expr.partition("=")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return replace_nested(cfg, path, value)


def load_config(path: str | None, overrides) -> Config:
    cfg = Config.from_json(Path(path).read_text()) if path else default_config()
    for expr in overrides or ():
        cfg = parse_override(cfg, expr)
    return cfg.validate()


def check_device(name: str) -> torch.device:
    """The device a CLI runs on: the card unless ``cpu`` was asked for."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the CPU")
    return device


def corpus_bow_indices(dataset, train_idx, tokenizer, k: int) -> list[int]:
    """The BoW loss's token ids: the ``k`` most frequent content tokens of
    the first 2000 training texts."""
    texts = []
    for i in train_idx[:2000]:
        s = dataset.corpus.get(int(i))
        if s:
            texts.append(s.get("text", ""))
    return get_top_k_vocab_indices(tokenizer, k, texts=texts)


def main(argv=None) -> dict:
    """Runs the script; returns ``best_bleu4``, the final ``test_metrics``,
    the ``trainer`` and its last ``state``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--montage", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--vocab", required=True, help="BERT-style vocab.txt")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="PATH=VAL")
    ap.add_argument("--out-dir", default="runs/latest")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument(
        "--bart-params", default=None,
        help="file written by cli.convert_hf: initialize the decoder from the pretrained"
             " weights (e.g. fnlp/bart-base-chinese, the reference's fine-tune setup)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = check_device(args.device)
    # no-op unless IST_COORDINATOR / IST_DISTRIBUTED are set
    initialize_distributed(device=device)
    device = rank_device(device)
    cfg = load_config(args.config, args.overrides)
    tc = cfg.training

    seed = seed_everything(tc.seed)
    tokenizer = ChineseCharTokenizer.from_vocab_file(args.vocab)
    logger.info("Tokenizer vocab: %d (pad=%d eos=%d bos=%d)",
                tokenizer.vocab_size, tokenizer.pad_token_id,
                tokenizer.eos_token_id, tokenizer.bos_token_id)
    if tokenizer.vocab_size != cfg.model.bart.vocab_size:
        logger.warning(
            "resizing model vocab %d -> tokenizer vocab %d",
            cfg.model.bart.vocab_size, tokenizer.vocab_size,
        )
        cfg = replace_nested(cfg, "model.bart.vocab_size", tokenizer.vocab_size)

    dataset = EEGTextDataset(
        args.data_dir, args.montage, tokenizer, cfg.data,
        augment=not args.no_augment, seed=tc.seed,
    )
    train_idx, val_idx, test_idx = split_indices(
        len(dataset),
        (cfg.data.train_split, cfg.data.val_split, cfg.data.test_split),
        tc.seed,
    )
    logger.info("samples: %d -> %d/%d/%d", len(dataset), len(train_idx),
                len(val_idx), len(test_idx))
    bow = corpus_bow_indices(dataset, train_idx, tokenizer, tc.loss.bow_vocab_size)
    logger.info("Selected %d BoW indices from vocabulary of size %d",
                len(bow), tokenizer.vocab_size)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mlog = get_logger(out_dir, config=cfg.to_dict()) if is_primary() else NullLogger()
    trainer = EEGTrainer(
        cfg, dataset, tokenizer,
        bow_indices=bow,
        train_indices=train_idx,
        val_indices=val_idx,
        metric_logger=mlog,
        checkpoint_dir=str(out_dir / "checkpoints"),
        device=device,
    )
    state = trainer.init_state(seed)
    if args.bart_params:
        state = graft_bart_params(state, args.bart_params)
    if args.resume:
        state = trainer.resume(state)

    try:
        state, best_bleu4 = trainer.train(state)
    finally:
        mlog.log({"train/finished": True})

    # final test evaluation
    trainer.val_indices = test_idx
    test_metrics = trainer.evaluate(state)
    mlog.log({f"test/{k}": v for k, v in test_metrics.items()
              if not isinstance(v, (list, tuple))})
    mlog.finish()
    logger.info("best BLEU-4 %.3f; test BLEU-4 %.3f", best_bleu4,
                test_metrics.get("bleu_4", 0.0))
    return dict(best_bleu4=best_bleu4, test_metrics=test_metrics, trainer=trainer,
                state=state)


if __name__ == "__main__":
    main()
