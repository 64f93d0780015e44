"""Trainer loop: epochs of accumulated train steps, beam-decode evaluation,
BLEU/diversity model selection, collapse tracking, checkpointing.

Port of ``imagined_speech_translation_tpu.training.trainer`` (``EEGTrainer``),
with its behaviour and names:

* the data order is a pure function of (seed, epoch): a numpy permutation of
  the train indices, cut into accumulation windows shaped ``(accum, micro,
  ...)``; ``start_window`` replays the rest of an interrupted epoch;
* window ``step`` of epoch ``epoch`` takes its dropout from a CPU
  ``torch.Generator`` seeded from ``(seed + 1000 + epoch, step)``, which
  stands in for ``jax.random.fold_in`` (the bits are torch's, not flax's);
* evaluation = the teacher-forced eval step, then beam search on the float32
  model in eval mode with BatchNorm unfolded, then the Chinese BLEU/ROUGE
  metrics, prediction diversity and the region weights; a short tail batch
  is padded with its last index and the outputs trimmed, as in JAX;
* model selection on BLEU-4 gated on diversity, collapse tolerance,
  patience, adaptive loss weights and the eval cadence as in JAX; Ctrl-C
  saves the live state unless it lands inside a step.

The state lives on one device: the card unless the caller asks for the CPU
(``device=``).  Parallelism follows the JAX trainer's mesh wiring: an
explicit ``mesh=``, else one that ``cfg.parallel``'s ``data_axis``,
``model_axis`` and ``dcn_axis`` build over the ranks of the process group
(``parallel.initialize_distributed``; one process a rank).  Every rank then
starts from the first rank's state, keeps its slices of the ``_TP_RULES``
tensors when ``model_axis > 1``, builds only its batch shard's rows of each
window and runs the parallel step, which computes the single-device step of
the global window.  Evaluation and model selection run on the primary, which
hands the metrics and its decisions (best model, patience, stop, the
adaptive loss weights) to every rank, so the ranks stay in step; under
tensor parallelism every rank first hands its slices to a whole model on the
primary, which evaluates alone.  Only the primary logs metrics and writes
checkpoints (whole, gathered from every rank's slices).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Iterable

import numpy as np
import torch

from ..config import Config, replace_nested
from ..decode import DecodeParams, build_generate_fn
from ..evaluation import ChineseEvaluator, prediction_diversity
from ..parallel import is_primary, make_mesh, shard_train_state
from ..parallel.data_parallel import DataParallel
from ..parallel.distributed import process_count
from ..parallel.mesh import Mesh, shard_batch
from .checkpoint import full_state_dicts
from .train_state import TrainModule
from ..utils.metrics import MetricLogger, NullLogger
from .checkpoint import CheckpointManager
from .losses import AdaptiveLossScheduler
from .optimizer import build_optimizer, learning_rates_at
from .train_state import TrainState, build_train_module, create_train_state
from .train_step import make_eval_step, make_train_step

logger = logging.getLogger(__name__)


def _dict_diff(a: dict, b: dict, prefix: str = "") -> list[str]:
    """Leaf-level ``key: old -> new`` lines for two nested config dicts."""
    out: list[str] = []
    for k in sorted(set(a) | set(b)):
        pa, pb = a.get(k), b.get(k)
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(pa, dict) and isinstance(pb, dict):
            out.extend(_dict_diff(pa, pb, path))
        elif pa != pb:
            out.append(f"{path}: {pa!r} -> {pb!r}")
    return out


def window_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The dropout stream of window ``step`` of ``epoch``."""
    words = np.random.SeedSequence((seed + 1000 + epoch, step)).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


class EEGTrainer:
    def __init__(
        self,
        cfg: Config,
        dataset,
        tokenizer,
        *,
        bow_indices,
        train_indices,
        val_indices,
        metric_logger: MetricLogger | None = None,
        checkpoint_dir: str | None = None,
        device: torch.device | str = "cuda",
        mesh: Mesh | None = None,
    ):
        pc = cfg.parallel
        if mesh is None and pc.requested:
            try:
                mesh = make_mesh(pc.data_axis, pc.model_axis, n_dcn=pc.dcn_axis)
            except ValueError as e:
                raise ValueError(f"{e}: data and tensor parallelism (ROADMAP 1.7a, 1.7b) run "
                                 "one process a rank; start them with IST_COORDINATOR, "
                                 "IST_NUM_PROCESSES and IST_PROCESS_ID "
                                 "(parallel.initialize_distributed)") from e
        if mesh is not None and (not mesh.over_ranks or len(mesh.devices) != process_count()):
            raise ValueError(f"the trainer's mesh must hold every rank of the process group "
                             f"({process_count()}), not {mesh.devices}")
        self.mesh = mesh
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass device='cpu' to train on the CPU")
        self.cfg = cfg
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.bow_indices = np.asarray(bow_indices, np.int32)
        self.train_indices = np.asarray(train_indices)
        self.val_indices = np.asarray(val_indices)
        # across ranks, metrics are the primary's to log
        self.leads = mesh is None or is_primary()
        self.mlog = (metric_logger if self.leads else None) or NullLogger()

        tc = cfg.training
        steps_per_epoch = max(
            len(self.train_indices) // (tc.batch_size * tc.grad_accum_steps), 1
        )
        self.total_steps = steps_per_epoch * tc.num_epochs
        self.steps_per_epoch = steps_per_epoch
        self.optimizer = None  # built in init_state

        self.evaluator = ChineseEvaluator()
        self.adaptive = (
            AdaptiveLossScheduler(tc.loss) if tc.loss.adaptive else None
        )
        self.ckpt = CheckpointManager(
            checkpoint_dir or tc.checkpoint.directory,
            max_epoch_keep=tc.checkpoint.max_to_keep,
        )

        gen_cfg = cfg.generation
        # decode ids come from the tokenizer (BOS start, SEP end), as in JAX
        self.decode_params = DecodeParams(
            max_length=gen_cfg.max_length,
            min_length=gen_cfg.min_length,
            num_beams=gen_cfg.num_beams,
            length_penalty=gen_cfg.length_penalty,
            early_stopping=gen_cfg.early_stopping,
            pad_token_id=tokenizer.pad_token_id,
            eos_token_id=tokenizer.sep_token_id,
            decoder_start_token_id=tokenizer.bos_token_id,
        )

        # host-side training state
        self.best_bleu4 = 0.0
        self.best_diversity = 0.0
        self.patience_counter = 0
        self.consecutive_repetitive = 0
        self.start_epoch = 0
        self.start_window = 0
        self._windows_done = 0
        self._current_epoch = 0
        # the state after the last completed step; a step updates the state
        # in place, so an interrupt inside one leaves nothing consistent
        self._live_state: TrainState | None = None
        self._in_step = False

        self._train_step = None
        self._whole_module = None  # the primary's evaluation model under TP

    # ------------------------------------------------------------------
    def init_state(self, seed: int | None = None) -> TrainState:
        """A fresh state: random weights from ``seed`` (default
        ``training.seed``) on the trainer's device, zero optimizer moments,
        the scheduler's loss weights."""
        tc = self.cfg.training
        seed = tc.seed if seed is None else seed
        init_weights = (
            self.adaptive.get_weights()
            if self.adaptive
            else AdaptiveLossScheduler(tc.loss).initial_weights()
        )
        # the module's token count follows the windows the dataset gives
        cfg = replace_nested(self.cfg, "data.n_timepoints", int(self.dataset.n_timepoints))
        self._module_cfg = cfg
        module = build_train_module(cfg, len(self.bow_indices), seed=seed, device=self.device)
        self.optimizer = build_optimizer(
            dict(module.named_parameters()), tc.optimizer, self.total_steps
        )
        state = create_train_state(module, self.optimizer, init_weights)
        data_parallel = None
        if self.mesh is not None:
            n_data = self.mesh.n_batch_shards
            if tc.batch_size % n_data:
                raise ValueError(
                    f"micro batch {tc.batch_size} not divisible by the mesh's"
                    f" {n_data} data-parallel devices"
                )
            state = shard_train_state(state, self.mesh,
                                      tp=self.mesh.shape.get("model", 1) > 1)
            if n_data > 1:  # one shard is the one-device step
                data_parallel = DataParallel.of(self.mesh)
        # the step runs this state's module (its BatchNorm buffers included)
        self._train_step = make_train_step(module, self.optimizer, self.cfg, self.bow_indices,
                                           data_parallel=data_parallel)
        return state

    @property
    def distributed(self) -> bool:
        """More than one rank: evaluation and decisions are the primary's."""
        return self.mesh is not None and process_count() > 1

    def _from_primary(self, obj):
        """``obj`` as the primary has it, on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def _train_batches(self, epoch: int, start_window: int = 0) -> Iterable[dict]:
        """Accumulation-window batches shaped (accum, micro, ...).

        ``start_window`` supports mid-epoch resume: the data order is a pure
        function of (seed, epoch), so skipping the first N windows replays
        the exact remainder of an interrupted epoch.  On a mesh each rank
        builds only its rows of every micro-batch (the dataset's windows
        depend on (seed, epoch, index) alone, so they are the global
        window's rows)."""
        tc = self.cfg.training
        rng = np.random.default_rng((tc.seed, epoch))
        idx = rng.permutation(self.train_indices)
        window = tc.batch_size * tc.grad_accum_steps
        n_windows = len(idx) // window
        for w in range(start_window, n_windows):
            chunk = idx[w * window : (w + 1) * window]
            if self.mesh is not None:
                chunk = shard_batch(
                    self.mesh, {"i": chunk.reshape(tc.grad_accum_steps, tc.batch_size)},
                    batch_axis=1)["i"].reshape(-1)
            batch = self.dataset.get_batch(chunk, epoch=epoch)
            out = {}
            for k, v in batch.items():
                if k == "channel_mask":
                    out[k] = v
                else:
                    out[k] = v.reshape((tc.grad_accum_steps, -1) + v.shape[1:])
            yield out

    def train_epoch(
        self, state: TrainState, epoch: int, *, start_window: int = 0
    ) -> tuple[TrainState, float]:
        tc = self.cfg.training
        losses = []
        t0 = time.time()
        self._windows_done = start_window
        self._current_epoch = epoch
        for step, batch in enumerate(
            self._train_batches(epoch, start_window), start=start_window
        ):
            self._in_step = True
            state, metrics = self._train_step(
                state, self._to_device(batch), window_generator(tc.seed, epoch, step)
            )
            self._in_step = False
            self._live_state = state
            self._windows_done = step + 1
            if step % max(tc.log_every_steps, 1) == 0:
                m = {k: float(v) for k, v in metrics.items()}
                lrs = learning_rates_at(tc.optimizer, self.total_steps, int(state.step))
                self.mlog.log(
                    {
                        "train/loss": m["loss"],
                        **{f"train/{k}": v for k, v in m.items() if k != "loss"},
                        "train/lr": lrs["encoder"],
                        **{f"train/lr_{g}": v for g, v in lrs.items()},
                    },
                    step=int(state.step),
                )
            losses.append(float(metrics["loss"]))
        avg = float(np.mean(losses)) if losses else float("inf")
        dt = time.time() - t0
        n_samples = len(losses) * tc.batch_size * tc.grad_accum_steps
        self.mlog.log(
            {
                "train/epoch_loss": avg,
                "train/samples_per_sec": n_samples / dt if dt > 0 else 0.0,
                "epoch": epoch,
            }
        )
        logger.info("Epoch %d - avg loss %.4f (%.1f samples/s)", epoch + 1, avg,
                    n_samples / dt if dt > 0 else 0.0)
        if self.mesh is not None:
            logger.info("rank %d: all-reduce %.3f s of %.3f s", torch.distributed.get_rank()
                        if self.distributed else 0, self._train_step.allreduce_seconds, dt)
        return state, avg

    # ------------------------------------------------------------------
    def evaluate(self, state: TrainState, *, epoch: int = 0) -> dict:
        """Validation metrics of ``state``; across ranks the primary
        evaluates and every rank returns its metrics."""
        state = self._whole(state)
        return self._from_primary(self._evaluate(state) if self.leads else None)

    def _whole(self, state: TrainState) -> TrainState | None:
        """``state`` with a whole module: under tensor parallelism every rank
        sends its slices (a collective) to a module of the single-device
        shapes on the primary, and the other ranks get None."""
        if state.tensor_parallel is None:
            return state
        module_sd, _, _ = full_state_dicts(state, moments=False)
        if not self.leads:
            return None
        if self._whole_module is None:
            with torch.device("meta"):
                whole = TrainModule(self._module_cfg, len(self.bow_indices))
            self._whole_module = whole.to_empty(device=self.device)
        self._whole_module.load_state_dict(module_sd, strict=True)
        return TrainState(step=state.step, module=self._whole_module,
                          opt_state=state.opt_state, loss_weights=state.loss_weights)

    def _evaluate(self, state: TrainState) -> dict:
        tc = self.cfg.training
        eval_bs = tc.eval_batch_size
        losses, n = [], 0
        comp_sums: dict[str, float] = {}
        predictions, targets = [], []
        model = state.module.model
        eval_step = make_eval_step(state.module, self.cfg, self.bow_indices)
        generate = build_generate_fn(model, self.decode_params)
        for start in range(0, len(self.val_indices), eval_bs):
            chunk = self.val_indices[start : start + eval_bs]
            real = len(chunk)
            if real < eval_bs:
                # pad the tail by repeating the last index and trim the
                # outputs, as the JAX trainer does for its static shapes
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], eval_bs - real)]
                )
            batch = self.dataset.get_batch(chunk)
            dev = self._to_device(batch)
            comps = eval_step(state, dev)
            losses.append(float(comps["loss"]) * real)
            for k, v in comps.items():
                if k != "loss":
                    comp_sums[k] = comp_sums.get(k, 0.0) + float(v) * real
            n += real
            model.eval()
            gen = generate(dev["eeg"], dev["channel_mask"])
            predictions.extend(
                t.strip()
                for t in self.tokenizer.batch_decode(gen.cpu().numpy()[:real])
            )
            for row in batch["labels"][:real]:
                ids = row[row != -100]
                targets.append(self.tokenizer.decode(ids).strip())
        metrics = {"val_loss": (sum(losses) / n) if n else float("inf")}
        metrics.update({k: v / n for k, v in comp_sums.items()} if n else {})
        metrics.update(self.evaluator.compute_all_metrics(predictions, targets))
        metrics.update(
            prediction_diversity(predictions, min_diversity=tc.min_diversity)
        )
        metrics["predictions"] = predictions[:10]
        metrics["targets"] = targets[:10]
        rw = model.brain_encoder.region_weights()
        for name, w in zip(rw["names"], rw["softmax"]):
            metrics[f"region_weight_{name}"] = float(w)
        return metrics

    # ------------------------------------------------------------------
    def check_improvement(self, bleu4: float, diversity: float, is_repetitive: bool) -> bool:
        tc = self.cfg.training
        if is_repetitive:
            return False
        if bleu4 > self.best_bleu4 and diversity >= tc.min_diversity:
            self.best_bleu4 = bleu4
            self.best_diversity = max(self.best_diversity, diversity)
            return True
        if (
            diversity > self.best_diversity + tc.diversity_improvement
            and bleu4 > self.best_bleu4 * tc.bleu_tolerance_frac
        ):
            self.best_diversity = diversity
            return True
        return False

    def _meta(self, epoch: int, metrics: dict, *, window: int = 0) -> dict:
        return {
            "epoch": epoch,
            "window": window,
            "best_bleu4": self.best_bleu4,
            "best_diversity": self.best_diversity,
            "metrics": {
                k: v for k, v in metrics.items()
                if not isinstance(v, (list, tuple))
            },
            "adaptive": self.adaptive.state_dict() if self.adaptive else None,
            "config": self.cfg.to_dict(),
        }

    def resume(self, state: TrainState, name: str | None = None) -> TrainState:
        name = name or self.ckpt.latest_epoch_checkpoint()
        if name is None or not self.ckpt.exists(name):
            return state
        state, meta = self.ckpt.restore(name, state)
        # a model-config change that keeps every shape (e.g. the head
        # counts) restores cleanly but computes another function: say so
        saved_model = (meta.get("config") or {}).get("model")
        if saved_model is not None:
            # compared as meta.json holds it (tuples read back as lists)
            current_model = json.loads(json.dumps(self.cfg.to_dict())).get("model")
            if saved_model != current_model:
                diffs = _dict_diff(saved_model, current_model, prefix="model")
                logger.warning(
                    "checkpoint '%s' was trained under a DIFFERENT model "
                    "config — restored weights may compute a different "
                    "function: %s",
                    name,
                    "; ".join(diffs[:8]) or "(nested difference)",
                )
        window = int(meta.get("window", 0))
        if window > 0:
            # mid-epoch checkpoint: replay the rest of that epoch
            self.start_epoch = int(meta.get("epoch", 0))
            self.start_window = window
        else:
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.start_window = 0
        self.best_bleu4 = meta.get("best_bleu4", 0.0)
        self.best_diversity = meta.get("best_diversity", 0.0)
        if self.adaptive and meta.get("adaptive"):
            self.adaptive.load_state_dict(meta["adaptive"])
            state.loss_weights = self.adaptive.get_weights()
        logger.info("Resumed from %s at epoch %d", name, self.start_epoch)
        return state

    def _select(self, val: dict):
        """Model selection on the validation metrics: the adaptive loss
        weights, improvement, patience and collapse counts.  Returns
        ``(improved, stop, new_weights or None)``."""
        tc = self.cfg.training
        bleu4 = val.get("bleu_4", 0.0)
        diversity = val.get("diversity_score", 0.0)
        repetitive = bool(val.get("is_repetitive", True))
        new_w = None
        if self.adaptive:
            comps = {
                k: val.get(k, 0.0)
                for k in ("loss_ce", "loss_align", "loss_bow", "loss_div", "loss_var")
            }
            new_w = self.adaptive.update(comps, diversity)
        improved = self.check_improvement(bleu4, diversity, repetitive)
        if improved:
            self.patience_counter = 0
            self.consecutive_repetitive = 0
        else:
            self.patience_counter += 1
            if repetitive:
                self.consecutive_repetitive += 1
        return improved, self.patience_counter >= tc.patience, new_w

    _HOST_STATE = ("best_bleu4", "best_diversity", "patience_counter", "consecutive_repetitive")

    def _host_state(self) -> dict:
        """The selection state that :meth:`_select` moves."""
        host = {k: getattr(self, k) for k in self._HOST_STATE}
        host["adaptive"] = self.adaptive.state_dict() if self.adaptive else None
        return host

    def _set_host_state(self, host: dict) -> None:
        for k in self._HOST_STATE:
            setattr(self, k, host[k])
        if self.adaptive:
            self.adaptive.load_state_dict(host["adaptive"])

    # ------------------------------------------------------------------
    def train(self, state: TrainState) -> tuple[TrainState, float]:
        tc = self.cfg.training
        try:
            for epoch in range(self.start_epoch, tc.num_epochs):
                start_window = self.start_window if epoch == self.start_epoch else 0
                state, train_loss = self.train_epoch(
                    state, epoch, start_window=start_window
                )
                # eval cadence: every eval_interval_epochs + the final epoch
                if (
                    (epoch + 1) % tc.eval_interval_epochs != 0
                    and epoch != tc.num_epochs - 1
                ):
                    if (epoch + 1) % tc.checkpoint.save_interval_epochs == 0:
                        self.ckpt.save_epoch(state, epoch, self._meta(epoch, {}))
                    continue
                val = self.evaluate(state, epoch=epoch)
                self.mlog.log(
                    {
                        **{
                            f"val/{k}": v
                            for k, v in val.items()
                            if not isinstance(v, (list, tuple))
                        },
                        "epoch": epoch,
                    }
                )
                if val.get("predictions"):
                    self.mlog.log_table(
                        "val/examples",
                        ["epoch", "prediction", "target"],
                        [
                            (epoch, p, t)
                            for p, t in zip(val["predictions"], val["targets"])
                        ],
                    )
                improved, stop, new_w, host = self._from_primary(
                    (*self._select(val), self._host_state()) if self.leads else None)
                if not self.leads:
                    self._set_host_state(host)
                if new_w is not None:
                    state.loss_weights = dict(new_w)
                    self.mlog.log({f"weights/{k}": v for k, v in new_w.items()})
                if improved:
                    self.ckpt.save_best(state, self._meta(epoch, val))
                    logger.info(
                        "New best model - BLEU-4 %.3f diversity %.3f",
                        val.get("bleu_4", 0.0), val.get("diversity_score", 0.0),
                    )
                if self.consecutive_repetitive >= tc.collapse_tolerance:
                    logger.warning(
                        "Repetitive generation for %d evals — consider adjusting "
                        "loss weights or learning rates",
                        self.consecutive_repetitive,
                    )
                if stop:
                    logger.info("Early stopping at epoch %d", epoch + 1)
                    break
                if (epoch + 1) % tc.checkpoint.save_interval_epochs == 0:
                    self.ckpt.save_epoch(state, epoch, self._meta(epoch, {}))
        except KeyboardInterrupt:
            if self._in_step:
                # the step updates the state in place: half an update is
                # no state to checkpoint
                logger.warning("Interrupted mid-step; no live state to checkpoint")
                raise
            live = self._live_state if self._live_state is not None else state
            self.ckpt.save_interrupted(
                live,
                self._meta(self._current_epoch, {}, window=self._windows_done),
            )
            logger.info("Interrupted — checkpoint saved")
            raise
        return state, self.best_bleu4
