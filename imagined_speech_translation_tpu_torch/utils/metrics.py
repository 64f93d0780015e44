"""Metrics / experiment-tracking facade.

The reference logs everything through wandb (project ``EEG-Chinese``,
``scripts/train.py:262-277``; per-step and per-epoch logs in
``src/training/trainer.py:127-131, 481-511``).  wandb is optional here: the
facade writes newline-delimited JSON locally (always), and mirrors to wandb
when the package is importable and ``WANDB_MODE`` is not disabled.

A copy of ``imagined_speech_translation_tpu.utils.metrics``: importing that
package loads jax (``utils/__init__.py`` imports ``utils.rng``), and the
port never does.  ``tests/test_torch_data_pipeline.py`` holds the copy to
the original.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Mapping


class MetricLogger:
    """Interface: ``log(metrics, step=None)``, ``log_summary``, ``finish``."""

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        raise NotImplementedError

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        self.log(dict(metrics, _summary=True))

    def log_table(
        self, name: str, columns: list[str], rows: list, step: int | None = None
    ) -> None:
        """Example tables (reference: per-epoch prediction/target wandb
        tables, trainer.py:481-511).  Default: one structured log record."""
        self.log(
            {"_table": name, "columns": list(columns),
             "rows": [list(r) for r in rows]},
            step=step,
        )

    def finish(self) -> None:
        pass


class NullLogger(MetricLogger):
    def log(self, metrics, step=None):
        pass


class JsonlLogger(MetricLogger):
    """Append-only JSONL metric log; one object per `log` call."""

    def __init__(self, path: str | Path, config: Mapping[str, Any] | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("a")
        self._t0 = time.time()
        if config is not None:
            self._write({"_config": dict(config)})

    def _write(self, obj):
        self._fh.write(json.dumps(obj, default=_json_default) + "\n")
        self._fh.flush()

    def log(self, metrics, step=None):
        rec = {"_t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["_step"] = int(step)
        rec.update(metrics)
        self._write(rec)

    def finish(self):
        self._fh.close()


class TeeLogger(MetricLogger):
    def __init__(self, *loggers: MetricLogger):
        self.loggers = loggers

    def log(self, metrics, step=None):
        for lg in self.loggers:
            lg.log(metrics, step=step)

    def log_table(self, name, columns, rows, step=None):
        for lg in self.loggers:
            lg.log_table(name, columns, rows, step=step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


class WandbLogger(MetricLogger):
    def __init__(self, project: str, config=None, tags=()):
        import wandb  # soft dependency

        self.run = wandb.init(project=project, config=dict(config or {}), tags=list(tags))

    def log(self, metrics, step=None):
        self.run.log(dict(metrics), step=step)

    def log_table(self, name, columns, rows, step=None):
        import wandb

        table = wandb.Table(columns=list(columns), data=[list(r) for r in rows])
        self.run.log({name: table}, step=step)

    def finish(self):
        self.run.finish()


def _json_default(x):
    try:
        import numpy as np

        if isinstance(x, (np.integer,)):
            return int(x)
        if isinstance(x, (np.floating,)):
            return float(x)
        if isinstance(x, np.ndarray):
            return x.tolist()
    except ImportError:
        pass
    if hasattr(x, "item"):
        return x.item()
    return str(x)


def get_logger(
    out_dir: str | Path | None,
    *,
    project: str = "EEG-Chinese",
    config: Mapping[str, Any] | None = None,
    tags=("composite_loss", "anti_collapse"),
    use_wandb: bool | None = None,
) -> MetricLogger:
    """Build the default logger stack: JSONL locally, wandb if available.

    ``use_wandb=None`` auto-detects (mirrors the reference's unconditional
    ``wandb.init``, scripts/train.py:269-275, but degrades gracefully).
    """
    loggers: list[MetricLogger] = []
    if out_dir is not None:
        loggers.append(JsonlLogger(Path(out_dir) / "metrics.jsonl", config=config))
    if use_wandb is None:
        use_wandb = os.environ.get("WANDB_MODE", "") not in ("disabled", "offline") and _has_wandb()
    if use_wandb:
        try:
            loggers.append(WandbLogger(project, config=config, tags=tags))
        except Exception:
            pass
    if not loggers:
        return NullLogger()
    if len(loggers) == 1:
        return loggers[0]
    return TeeLogger(*loggers)


def _has_wandb() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False
