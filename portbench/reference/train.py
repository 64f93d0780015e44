"""The plain reference of the training step, in float32: the composite loss
of the configuration's ``training.loss`` section over the teacher-forced
model of :mod:`.model` in train mode, the gradients averaged over the
micro-batches, clipped by their global norm, and the three-group AdamW with
the warmup schedule of ``training.optimizer``.

The loss (the configuration's ``EnhancedCompositeSeq2SeqLoss``, as the
paper's training describes it): label-smoothed cross-entropy over the
labels (``-100`` ignored), symmetric InfoNCE between the projected EEG
feature and the mask-pooled decoder states at temperature ``tau``, a
bag-of-words BCE from the EEG feature onto the multi-hot of the BoW tokens
in the labels, the mean absolute off-diagonal cosine similarity of the
batch's EEG features, and ``mean(exp(-var))`` over their dimensions.

:func:`follow` runs the optimizer steps on the same batches, with the same
dropout streams (each step's CPU generator, one draw of its base seed, then
a generator ``base + i`` per micro-batch), from the same weights as the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import Dropout, Precision, RefModel, exact_float32

COMPONENTS = ("ce", "align", "bow", "div", "var")
GROUPS = (("encoder", "brain_encoder", "encoder_lr"), ("projection", "eeg_to_bart", "projection_lr"),
          ("bart", "bart", "bart_lr"))


def composite(lc: dict, weights: dict, logits, labels, feat, hidden, attn_mask, heads, linear):
    """(total, components) of one micro-batch."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    eps = lc["label_smoothing"]
    nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
    ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)

    m = attn_mask.float()[..., None]
    text = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    e = linear(feat, "loss_heads.eeg_proj")
    t = linear(text, "loss_heads.txt_proj")
    e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)
    sim = torch.matmul(e, t.t()) / lc["contrastive_tau"]
    diag = torch.arange(sim.shape[0], device=sim.device)
    align = 0.5 * (-F.log_softmax(sim, -1)[diag, diag].mean()
                   - F.log_softmax(sim, 0)[diag, diag].mean())

    present = torch.zeros(labels.shape[0], logits.shape[-1], device=labels.device)
    present.scatter_add_(1, safe, valid.float())
    target = present.clamp(0.0, 1.0)[:, heads["bow"]]
    z = linear(feat, "loss_heads.bow_head")
    bow = -(target * F.logsigmoid(z) + (1.0 - target) * F.logsigmoid(-z)).mean()

    f = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-8)
    s = torch.matmul(f, f.t())
    b = s.shape[0]
    div = (s * (1.0 - torch.eye(b, device=s.device))).abs().sum() / max(b * (b - 1), 1)
    var = torch.exp(-feat.var(dim=0, unbiased=False)).mean()
    comps = dict(ce=ce, align=align, bow=bow, div=div, var=var)
    return sum(weights[k] * comps[k] for k in COMPONENTS), comps


def learning_rate(base: float, oc: dict, count: int) -> float:
    """Warmup from 0 over ``warmup_steps`` (the steps this reference follows
    never leave it)."""
    if count >= oc["warmup_steps"]:
        raise ValueError("the reference follows the warmup only")
    return base * count / oc["warmup_steps"]


@exact_float32()
def follow(cfg: dict, w0: dict, batches: list, step_seeds: list, bow: list, *,
           operand_bytes: int, precision: Precision | None = None) -> dict:
    """Run ``len(batches)`` optimizer steps from weights ``w0`` (the train
    module's names: ``model.*`` and ``loss_heads.*``).  Returns each step's
    loss components and total, the first step's clipped gradient norm by
    leaf, and each leaf's change over the steps."""
    tc, lc, oc = cfg["training"], cfg["training"]["loss"], cfg["training"]["optimizer"]
    weights = {k: lc[f"w_{k}"] for k in COMPONENTS}
    trainable = [n for n in w0 if not n.endswith(("running_mean", "running_var"))]
    params = {n: w0[n].detach().clone().requires_grad_() for n in trainable}
    frozen = {n: w0[n] for n in w0 if n not in params}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    labels_of = {n: next((g for g, sub, _ in GROUPS if sub in n), "projection") for n in params}
    base = {g: oc[key] for g, _, key in GROUPS}
    heads = {"bow": torch.as_tensor(bow, device=next(iter(params.values())).device)}
    out = {"losses": [], "grad_norms": None, "change_norms": None}
    for count, (batch, seed) in enumerate(zip(batches, step_seeds)):
        step_gen = torch.Generator().manual_seed(seed)
        base_seed = int(torch.randint(0, 2**62, (), generator=step_gen))
        accum = batch["eeg"].shape[0]
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        sums = {k: 0.0 for k in COMPONENTS}
        for i in range(accum):
            w = {**{n.removeprefix("model."): p for n, p in params.items()},
                 **{n.removeprefix("model."): t for n, t in frozen.items()}}
            model = RefModel(cfg, w, precision)
            drop = Dropout(torch.Generator().manual_seed(base_seed + i), operand_bytes)
            feat, proj = model.encode(batch["eeg"][i].float(), batch["channel_mask"], drop,
                                      train=True)
            logits, hidden = model.decode(batch["decoder_input_ids"][i], proj, drop,
                                          return_hidden=True)
            total, comps = composite(lc, weights, logits, batch["labels"][i].long(), feat, hidden,
                                     batch["attention_mask"][i], heads, model.linear)
            g = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            for (n, acc), gi in zip(grads.items(), g):
                if gi is not None:
                    acc.add_(gi)
            for k in COMPONENTS:
                sums[k] += float(comps[k].detach())
            del feat, proj, logits, hidden, total, comps, g
        step = {k: v / accum for k, v in sums.items()}
        step["loss"] = sum(weights[k] * step[k] for k in COMPONENTS)
        out["losses"].append(step)
        with torch.no_grad():
            for acc in grads.values():
                acc.div_(accum)
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            clip = 1.0 if norm < tc["optimizer"]["max_grad_norm"] else float(
                tc["optimizer"]["max_grad_norm"] / norm)
            b1, b2, eps, wd = oc["adam_b1"], oc["adam_b2"], oc["adam_eps"], oc["weight_decay"]
            bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
            if count == 0:
                out["grad_norms"] = {n: float(torch.linalg.vector_norm(g)) * clip
                                     for n, g in grads.items()}
            for n, p in params.items():
                gc = grads[n] * clip
                mu[n].mul_(b1).add_((1.0 - b1) * gc)
                nu[n].mul_(b2).add_((1.0 - b2) * gc * gc)
                upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + eps) + wd * p
                p.sub_(learning_rate(base[labels_of[n]], oc, count) * upd)
        del grads
    with torch.no_grad():
        out["change_norms"] = {n: float(torch.linalg.vector_norm(p - w0[n]))
                               for n, p in params.items()}
    return out
