"""Checkpoints with the JAX package's names and cadence.

Port of ``imagined_speech_translation_tpu.training.checkpoint``: ``best_model``
on improvement, ``checkpoint_epoch_{N}`` every save interval (the newest
``max_epoch_keep`` kept), ``interrupted_checkpoint`` on Ctrl-C.  Each
checkpoint is a directory holding

* ``state.pt``: ``torch.save`` of the train state -- ``step``, the module's
  ``state_dict()`` (parameters and BatchNorm running statistics: the JAX
  state's ``params`` and ``batch_stats``), the optimizer state (``count``,
  ``mu``, ``nu``) and ``loss_weights``;
* ``meta.json``: the trainer's host-side metadata, as in the JAX package.

A restore loads onto the target state's device and is strict: an entry that
is missing, extra, or of another shape or dtype raises.  Across ranks the
primary writes, between barriers, and removes old epochs; every rank
restores onto its own device.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..parallel.distributed import is_primary, sync_hosts
from .optimizer import FusedAdamWState
from .train_state import TrainState


class CheckpointManager:
    def __init__(self, directory: str | Path, *, max_epoch_keep: int = 3):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_epoch_keep = max_epoch_keep

    # ------------------------------------------------------------------
    def _save(self, name: str, state: TrainState, meta: dict[str, Any]):
        path = self.dir / name
        if is_primary() and path.exists():
            shutil.rmtree(path)
        sync_hosts("ckpt_clear")
        if is_primary():
            path.mkdir()
            opt = state.opt_state
            torch.save({
                "step": int(state.step),
                "module": state.module.state_dict(),
                "opt_state": {"count": int(opt.count), "mu": opt.mu, "nu": opt.nu},
                "loss_weights": {k: float(v) for k, v in state.loss_weights.items()},
            }, path / "state.pt")
            (path / "meta.json").write_text(json.dumps(meta, default=_js))
        sync_hosts("ckpt_done")

    def save_best(self, state, meta):
        self._save("best_model", state, meta)

    def save_epoch(self, state, epoch: int, meta):
        self._save(f"checkpoint_epoch_{epoch + 1}", state, meta)
        self._gc_epochs()

    def save_interrupted(self, state, meta):
        self._save("interrupted_checkpoint", state, meta)

    def _epoch_dirs(self) -> list[Path]:
        return sorted(self.dir.glob("checkpoint_epoch_*"),
                      key=lambda p: int(p.name.rsplit("_", 1)[1]))

    def _gc_epochs(self):
        if not is_primary():
            return
        for p in self._epoch_dirs()[: -self.max_epoch_keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, name: str, target_state: TrainState) -> tuple[TrainState, dict]:
        """Load ``name`` into ``target_state``'s tensors in place (on their
        device); returns (state, meta)."""
        path = self.dir / name
        device = next(target_state.module.parameters()).device
        saved = torch.load(path / "state.pt", map_location=device, weights_only=True)
        _copy_strict(target_state.module.state_dict(), saved["module"], "module")
        opt = target_state.opt_state
        _copy_strict(opt.mu, saved["opt_state"]["mu"], "mu")
        _copy_strict(opt.nu, saved["opt_state"]["nu"], "nu")
        if set(saved["loss_weights"]) != set(target_state.loss_weights):
            raise KeyError(f"{name}: loss weights {sorted(saved['loss_weights'])} != "
                           f"{sorted(target_state.loss_weights)}")
        meta = json.loads((path / "meta.json").read_text())
        state = replace(
            target_state, step=int(saved["step"]),
            opt_state=FusedAdamWState(count=int(saved["opt_state"]["count"]),
                                      mu=opt.mu, nu=opt.nu),
            loss_weights=dict(saved["loss_weights"]),
        )
        return state, meta

    def latest_epoch_checkpoint(self) -> str | None:
        epochs = self._epoch_dirs()
        return epochs[-1].name if epochs else None

    def exists(self, name: str) -> bool:
        return (self.dir / name).exists()


@torch.no_grad()
def _copy_strict(target: dict[str, torch.Tensor], saved: dict[str, torch.Tensor], what: str):
    missing, extra = sorted(set(target) - set(saved)), sorted(set(saved) - set(target))
    if missing or extra:
        raise KeyError(f"checkpoint {what}: missing {missing}, unexpected {extra}")
    for key, t in target.items():
        s = saved[key]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"checkpoint {what}.{key}: {s.dtype} {tuple(s.shape)} != "
                             f"{t.dtype} {tuple(t.shape)}")
        t.copy_(s)


def _js(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if hasattr(x, "item"):
        return x.item()
    return str(x)
