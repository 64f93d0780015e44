"""Train and eval steps with gradient accumulation.

Port of ``imagined_speech_translation_tpu.training.train_step``: micro
batches of ``batch_size`` accumulated ``grad_accum_steps`` times, the loss
averaged over the window, then one clipped AdamW step.  The JAX package runs
the window as one ``lax.scan``; here it is a Python loop, with the same
numerics:

* under mixed precision one bfloat16 copy of the parameters is made per
  window, and gradients are taken with respect to that copy (not under
  ``torch.autocast``, which keeps float32 weights and rounds elsewhere);
  the EEG enters in bfloat16, and BatchNorm's running statistics enter their
  update in bfloat16 and are stored in float32 (``models.layers.RegionNorm``);
* gradients accumulate in a ``grad_accum_dtype`` carry (bfloat16 by default
  under mixed precision, float32 otherwise), and ``g / accum`` is computed in
  the carry's dtype and then widened to float32 for the optimizer;
* the dropout stream of micro-step ``i`` is a generator seeded from one draw
  of the step's generator and ``i`` (``jax.random.fold_in(rng, i)``).

The eval step runs the float32 parameters on float32 EEG whatever
``training.mixed_precision`` says, as the JAX package's does.

With ``data_parallel`` (a ``parallel.data_parallel.DataParallel``) each rank
runs the step on its rows of the window under that context, so its loss is
its share of the global micro-batch's (dropout bits, BatchNorm statistics and
batch-coupled losses included).  After the accumulation and the float32
``/ accum`` the gradients are summed over the ranks once, in flat buckets,
and so are the metrics: the clip and the AdamW update see the global
gradient, identical on every rank, and every rank reports the global
numbers.  ``train_step.allreduce_seconds`` adds up the host time of those
all-reduces.

``batch`` leaves are shaped ``(accum, micro_batch, ...)`` except
``channel_mask``, which is shared.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.func import functional_call

from ..config import Config
from ..parallel import data_parallel as dpx
from .losses import composite_loss, label_smoothed_ce
from .optimizer import FusedAdamW
from .train_state import TrainModule, TrainState

_COMPONENTS = ("loss_ce", "loss_align", "loss_bow", "loss_div", "loss_var")


def _micro_generator(base_seed: int, i: int) -> torch.Generator:
    return torch.Generator().manual_seed(base_seed + i)


def make_loss_fn(module: TrainModule, cfg: Config, bow_indices, *,
                 mixed: bool | None = None):
    """``loss_fn(params, micro_batch, generator, loss_weights) -> (total,
    components)``.  ``params`` maps the module's parameter names to the
    tensors to run it with (the bfloat16 copy under mixed precision).  With
    a generator the forward runs in train mode (dropout from it, BatchNorm on
    batch statistics, running statistics updated in place); with ``None`` in
    eval mode, as :func:`make_eval_step`'s.  ``mixed`` (default
    ``training.mixed_precision``) casts the EEG to bfloat16."""
    loss_cfg = cfg.training.loss
    if mixed is None:
        mixed = cfg.training.mixed_precision

    def loss_fn(params, micro_batch, generator, loss_weights):
        eeg = micro_batch["eeg"]
        if mixed:
            eeg = eeg.to(torch.bfloat16)
        module.train(generator is not None)
        logits, aux = functional_call(
            module, params, (eeg, micro_batch["decoder_input_ids"], micro_batch["channel_mask"]),
            {"generator": generator},
        )
        labels = micro_batch["labels"]
        if not loss_cfg.composite:
            total, _ = label_smoothed_ce(logits, labels)
            return total, {"loss_ce": total}
        heads = {k.removeprefix("loss_heads."): v for k, v in params.items()
                 if k.startswith("loss_heads.")}

        def heads_apply(eeg_feat, text_feat):
            return functional_call(module.loss_heads, heads, (eeg_feat, text_feat))

        bow = torch.as_tensor(bow_indices, dtype=torch.long, device=logits.device)
        return composite_loss(
            logits=logits, labels=labels, eeg_feat=aux["features"], decoder_hidden=aux["hidden"],
            decoder_mask=micro_batch["attention_mask"], heads_apply=heads_apply,
            bow_indices=bow, weights=loss_weights, cfg=loss_cfg,
        )

    return loss_fn


def _total(comps: dict, weights: dict):
    return sum(weights[k.removeprefix("loss_")] * v if k.removeprefix("loss_") in weights else v
               for k, v in comps.items())


def make_train_step(module: TrainModule, optimizer: FusedAdamW, cfg: Config,
                    bow_indices, *, data_parallel: dpx.DataParallel | None = None) -> Callable:
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``;
    ``generator`` is a CPU ``torch.Generator`` (the step's dropout key,
    the same on every rank).  The state's parameters and optimizer state
    update in place."""
    loss_fn = make_loss_fn(module, cfg, bow_indices)
    accum = cfg.training.grad_accum_steps
    mixed = cfg.training.mixed_precision
    accum_dtype = getattr(torch, cfg.training.grad_accum_dtype) if mixed else torch.float32
    names = (_COMPONENTS if cfg.training.loss.composite else ("loss_ce",))

    def train_step(state: TrainState, batch: dict, generator: torch.Generator):
        params = dict(state.module.named_parameters())
        # one forward copy per window (bf16 under mixed precision), shared by
        # all micro-steps; its leaves are what gradients are taken against
        fwd = {n: p.detach().to(torch.bfloat16 if mixed else p.dtype).requires_grad_()
               for n, p in params.items()}
        leaves = list(fwd.values())
        grads_acc = [torch.zeros_like(p, dtype=accum_dtype) for p in leaves]
        comps_acc = {k: 0.0 for k in names}
        base_seed = int(torch.randint(0, 2**62, (), generator=generator))
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items() if k != "channel_mask"}
            micro["channel_mask"] = batch["channel_mask"]
            with dpx.installed(data_parallel, micro["eeg"].shape[0]):
                total, comps = loss_fn(fwd, micro, _micro_generator(base_seed, i),
                                       state.loss_weights)
                # parameters a configuration leaves unused (the loss heads
                # without the composite loss, the attention of the cnn-only
                # ablation) get zero gradients, as jax.grad gives them
                grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                            materialize_grads=True)
            for acc, g in zip(grads_acc, grads):
                acc.add_(g.to(acc.dtype))
            for k in names:
                comps_acc[k] = comps_acc[k] + comps[k].detach()
        grads = {n: (acc / accum).float() for n, acc in zip(fwd, grads_acc)}
        comps = {k: v / accum for k, v in comps_acc.items()}
        if data_parallel is not None:
            if grads_acc and grads_acc[0].is_cuda:
                # the all-reduce's time starts when the gradients are ready
                torch.cuda.synchronize(grads_acc[0].device)
            t0 = time.perf_counter()
            dpx.all_reduce_buckets(list(grads.values()), data_parallel.group)
            summed = torch.stack([comps[k].float() for k in names])
            dpx.all_reduce_buckets([summed], data_parallel.group)
            comps = dict(zip(names, summed.unbind()))
            train_step.allreduce_seconds += time.perf_counter() - t0
        grad_norm = optimizer.update(params, grads, state.opt_state)
        state.step += 1
        metrics = dict(comps, loss=_total(comps, state.loss_weights), grad_norm=grad_norm)
        return state, metrics

    train_step.allreduce_seconds = 0.0
    return train_step


def make_eval_step(module: TrainModule, cfg: Config, bow_indices) -> Callable:
    """Teacher-forced validation loss: ``eval_step(state, batch) -> metrics``,
    in float32 (the master parameters on float32 EEG) under any precision
    setting."""
    loss_fn = make_loss_fn(module, cfg, bow_indices, mixed=False)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        params = dict(state.module.named_parameters())
        total, comps = loss_fn(params, batch, None, state.loss_weights)
        return dict(comps, loss=total)

    return eval_step
