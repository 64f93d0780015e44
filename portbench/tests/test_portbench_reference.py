"""The plain reference held to the port at tiny widths on the CPU: the
frontend, the encoder, the decoder's logits, the beam's ids and the training
step.  The port runs in float32 here, so the two agree to rounding; the
benchmark's cells run the port in bfloat16 on the card and hold it to the
reference by the limits of ``portbench/limits``."""

import numpy as np
import pytest
import torch

from imagined_speech_translation_tpu_torch.data import RegionSpec
from imagined_speech_translation_tpu_torch.frontend import SignalFrontend
from imagined_speech_translation_tpu_torch.models import EEGDecodingModel

from portbench import inputs, program
from portbench.core import Run
from portbench.reference.frontend import preprocess
from portbench.reference.judge import leaf_gap, serve_gaps
from portbench.reference.model import RefModel
from portbench.reference.train import follow
from portbench.tests.tiny import tiny_tree

CPU = torch.device("cpu")
HEADS = [(2, 2, 2), (4, 2, 2)]


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def port_model(tree, seed):
    cfg = program.config(tree)
    with torch.device("meta"):
        model = EEGDecodingModel(cfg.model, cfg.data.n_timepoints)
    model = model.to_empty(device=CPU)
    spec = program._load(model, seed, CPU)
    return cfg, model.eval(), inputs.weights(spec, seed, CPU)


def stacked(tree, n=3, seed=7):
    labels = inputs.montage(64)
    gather, mask = inputs.region_gather(labels, 16)
    raw = inputs.windows(seed, n, 64, tree["data"]["n_timepoints"], CPU).numpy()
    return labels, gather, mask, raw


def test_frontend_matches_the_port():
    tree = tiny_tree()
    labels, gather, mask, raw = stacked(tree)
    cfg = program.config(tree)
    spec = RegionSpec.from_channel_names(labels)
    clean = SignalFrontend(cfg.frontend).preprocess(torch.from_numpy(raw))
    port = clean[:, torch.as_tensor(spec.gather_indices.reshape(-1))].reshape(
        len(raw), *spec.channel_mask.shape, -1)
    port = torch.where(torch.as_tensor(spec.channel_mask)[None, :, :, None], port, 0.0)
    np.testing.assert_array_equal(spec.channel_mask, mask)
    assert rel(port, preprocess(raw, tree["frontend"], gather, mask)) < 1e-4


@pytest.mark.parametrize("heads", HEADS)
def test_encoder_and_decoder_logits_match_the_port(heads):
    tree = tiny_tree(heads)
    cfg, model, w = port_model(tree, 11)
    _, gather, mask, raw = stacked(tree)
    x = torch.as_tensor(preprocess(raw, tree["frontend"], gather, mask), dtype=torch.float32)
    m = torch.as_tensor(mask)
    ids = torch.randint(105, 256, (len(raw), 8), generator=torch.Generator().manual_seed(3))
    ref = RefModel(tree, w)
    with torch.no_grad():
        feat, enc = model.encode(x, m)
        rfeat, rproj = ref.encode(x, m)
        assert rel(feat, rfeat) < 1e-4
        assert rel(enc[:, 0], rproj) < 1e-4
        assert rel(model(x, ids, m), ref.decode(ids, rproj)) < 1e-4


@pytest.mark.parametrize("heads", HEADS)
def test_served_ids_lie_within_the_reference_beams(heads):
    """The port's float32 beam, decoded from raw windows, has every token
    among the reference's best ``K`` after its prefix (to rounding)."""
    tree = tiny_tree(heads)
    traffic = {"decode_length": 8, "compute_dtype": "float32", "n_channels": 64}
    from portbench.serving import build

    run = Run(cell={}, config={"config": tree}, traffic=traffic, limits={}, seed=5, seconds=0,
              trace=False, device=CPU)
    cfg, decode_fn, tok, labels, wspec, pool = build(run, 6)
    decode_fn(pool)
    ids = tok.record[-1]
    assert (ids[:, 0] == inputs.vocab(256).index("[CLS]")).all()
    w = inputs.weights(wspec, 5, CPU)
    gather, mask = inputs.region_gather(labels, 16)
    gaps = serve_gaps(tree, w, pool, ids, gather, mask, eos=inputs.vocab(256).index("[SEP]"),
                      beams=3, device=CPU)
    assert gaps.max() < 1e-4


def test_training_steps_match_the_port():
    """Three float32 steps of the port (dropout on) and of the reference
    from the same weights, batches and dropout streams."""
    tree = tiny_tree()
    tree["training"]["mixed_precision"] = False
    cfg = program.config(tree)
    tc = cfg.training
    state, step_fn, bow, wspec = program.training(cfg, 9, CPU, 100)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(cfg.model.region_channel_counts):
        mask[r, :n] = True
    batches = inputs.train_batches(9, 3, tc.grad_accum_steps, tc.batch_size, mask,
                                   cfg.data.n_timepoints, 8, 256, CPU)
    w0 = {n: t.clone() for n, t in inputs.weights(wspec, 9, CPU).items()}
    losses = []
    for k, batch in enumerate(batches):
        m = step_fn(state, batch, torch.Generator().manual_seed(100 + k))[1]
        losses.append(float(m["loss"]))
        if k == 0:
            grads = {n: float(torch.sqrt(v.sum() / (1 - tc.optimizer.adam_b2)))
                     for n, v in state.opt_state.nu.items()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - w0[n]))
              for n, p in state.module.named_parameters()}
    ref = follow(tree, w0, batches, [100, 101, 102], bow, operand_bytes=4)
    for p, r in zip(losses, ref["losses"]):
        assert abs(p - r["loss"]) / r["loss"] < 1e-5
    med = np.median(list(ref["grad_norms"].values()))
    keep = {n for n, v in ref["grad_norms"].items() if v >= 1e-3 * med}.__contains__
    assert leaf_gap(grads, ref["grad_norms"], keep)[0] < 1e-4
    assert leaf_gap(change, ref["change_norms"], keep)[0] < 5e-3
