"""Train the wake-detector twin on the CSV event corpus.

Port of ``imagined_speech_translation_tpu.cli.wake_train``: the same data,
the twin (``wake.WakeMLP``, a batched conv/MLP) and Adam, full-batch steps on
the card, with the JAX script's standardisation, labels, seed (42), epoch
order (``np.random.default_rng(epoch).permutation``), drop-remainder batches
and logging cadence.  The weights are written with ``torch.save`` (the
twin's ``state_dict``, CPU tensors), not as flax msgpack.  It runs on the
card unless ``--device cpu`` is given, and never falls back from one to the
other::

    python -m imagined_speech_translation_tpu_torch.cli.wake_train \\
        <catalog.csv> <training_dir> [--epochs N] [--lr 1e-3] [--batch 32] \\
        [--out wake_twin.pt] [--device cuda|cpu]

:func:`train_wake_twin` is the loop alone, on a ``wake.dataset.WakeDataset``
in memory.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from ..utils.cache import enable_persistent_cache
from ..wake import WakeMLP, make_wake_train_step
from ..wake.dataset import WakeDataset, load_wake_dataset
from .train import check_device

logger = logging.getLogger(__name__)


def standardize(data: np.ndarray) -> np.ndarray:
    """Each feature over every sequence and step, as the JAX script does: the
    raw time column is in seconds and dwarfs velocity."""
    mean = data.reshape(-1, 2).mean(axis=0)
    std = data.reshape(-1, 2).std(axis=0) + 1e-6
    return ((data - mean) / std).astype(np.float32)


def train_wake_twin(ds: WakeDataset, *, epochs: int = 200, lr: float = 1e-3, batch: int = 32,
                    device: torch.device | str = "cuda"):
    """The JAX script's loop on ``ds``: labels ``min(ds.labels(), seq_len -
    1)``, standardised features, the twin initialised from seed 42, each
    epoch's permutation from ``default_rng(epoch)`` cut into full batches of
    ``min(batch, n)`` (the remainder dropped).  Returns ``(model, acc)``:
    the trained twin on ``device`` and its accuracy on every sequence."""
    device = torch.device(device)
    labels = np.minimum(ds.labels(), ds.seq_len - 1)
    logger.info("samples=%d seq_len=%d", len(ds.data), ds.seq_len)
    data = torch.from_numpy(standardize(ds.data)).to(device)
    targets = torch.from_numpy(labels.astype(np.int64)).to(device)

    model = WakeMLP(ds.seq_len, n_classes=ds.seq_len).to(device)
    init_fn, step_fn, predict_fn = make_wake_train_step(model, lr)
    model, opt = init_fn(42)

    def accuracy() -> float:
        return float((predict_fn(model, data) == targets).float().mean())

    n = len(data)
    bs = min(batch, n)
    t0 = time.time()
    for epoch in range(epochs):
        order = torch.from_numpy(np.random.default_rng(epoch).permutation(n)).to(device)
        losses = []
        for s in range(0, n - bs + 1, bs):
            idx = order[s : s + bs]
            model, opt, loss = step_fn(model, opt, data[idx], targets[idx])
            losses.append(float(loss))
        if epoch % max(epochs // 10, 1) == 0:
            logger.info("epoch %d loss=%.4f acc=%.3f", epoch, np.mean(losses), accuracy())
    acc = accuracy()
    logger.info("final acc=%.3f (%.1fs)", acc, time.time() - t0)
    return model, acc


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("catalog")
    ap.add_argument("training_dir")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default="wake_twin.pt")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = check_device(args.device)

    enable_persistent_cache()
    ds = load_wake_dataset(args.catalog, args.training_dir)
    model, acc = train_wake_twin(ds, epochs=args.epochs, lr=args.lr, batch=args.batch,
                                 device=device)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, args.out)
    logger.info("saved %s", args.out)
    return acc


if __name__ == "__main__":
    main()
