"""The benchmark's operation counts against ``torch.utils.flop_counter``
over the plain reference, at tiny widths on the CPU.

What each side leaves out: the counter sees the products the reference
computes (matrix products, batched products, convolutions) and nothing
elementwise; the count leaves out the same.  The reference's decoder runs
``length x length`` scores (no causal saving), as the count does.  The
count's backward is twice the forward's products; autograd skips the
gradient of the input EEG, which the count keeps."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, inputs
from portbench.reference.model import Dropout, RefModel
from portbench.reference.train import COMPONENTS, composite, follow
from portbench.tests.tiny import tiny_tree

CPU = torch.device("cpu")


def spec_of(tree):
    from imagined_speech_translation_tpu_torch.training.train_state import TrainModule

    from portbench import program

    cfg = program.config(tree)
    with torch.device("meta"):
        module = TrainModule(cfg, tree["training"]["loss"]["bow_vocab_size"])
    return [(n, tuple(t.shape)) for n, t in module.state_dict().items()]


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_serving_window_count_matches_the_counter():
    tree = tiny_tree()
    w = inputs.weights(spec_of(tree), 1, CPU)
    ref = RefModel(tree, {n[len("model."):]: t for n, t in w.items() if n.startswith("model.")})
    batch, beams, length = 3, 3, 7
    x = torch.randn(batch, 4, 16, tree["data"]["n_timepoints"])
    mask = torch.as_tensor(inputs.region_gather(inputs.montage(64), 16)[1])
    ids = torch.randint(0, 256, (batch * beams, length))

    def serve():
        with torch.no_grad():
            _, proj = ref.encode(x, mask)
            ref.decode(ids, proj.repeat_interleave(beams, 0))

    assert counted(serve) == batch * flops.serve_window_flops(tree, beams, length)


def test_training_step_count_matches_the_counter():
    """The forward of every micro-batch exactly; the backward of the
    matrix products at twice their forward.  The counter's convolution
    backward is not compared: it counts a grouped convolution's weight
    gradient as if it had no groups (``groups + 1`` times the forward where
    the work is twice it), and the stem's convolutions are grouped."""
    tree = tiny_tree()
    tc = tree["training"]
    w = inputs.weights(spec_of(tree), 2, CPU)
    mask = np.zeros((4, 16), bool)
    for r, n in enumerate(tree["model"]["region_channel_counts"]):
        mask[r, :n] = True
    accum, b = tc["grad_accum_steps"], tc["batch_size"]
    batch = inputs.train_batches(2, 1, accum, b, mask, tree["data"]["n_timepoints"], 8, 256, CPU)
    bow = list(range(105, 105 + tc["loss"]["bow_vocab_size"]))
    with FlopCounterMode(display=False) as counter:
        follow(tree, w, batch, [0], bow, operand_bytes=4)
    ops = counter.get_flop_counts()["Global"]
    products = {k: v for k, v in ops.items() if "convolution" not in str(k)}
    with torch.no_grad(), FlopCounterMode(display=False) as fwd:
        for i in range(accum):
            model = RefModel(tree, {n.removeprefix("model."): t for n, t in w.items()})
            drop = Dropout(torch.Generator().manual_seed(i), 4)
            feat, proj = model.encode(batch[0]["eeg"][i], batch[0]["channel_mask"], drop, True)
            _, hidden = model.decode(batch[0]["decoder_input_ids"][i], proj, drop, True)
            composite(tc["loss"], {k: 1.0 for k in COMPONENTS}, _, batch[0]["labels"][i], feat,
                      hidden, batch[0]["attention_mask"][i], {"bow": torch.tensor(bow)},
                      model.linear)
    assert fwd.get_total_flops() == accum * flops.train_forward_flops(tree, b, 8, len(bow))
    fwd_products = sum(v for k, v in fwd.get_flop_counts()["Global"].items()
                       if "convolution" not in str(k))
    assert sum(products.values()) == 3 * fwd_products
    assert 3 * accum * flops.train_forward_flops(tree, b, 8, len(bow)) == flops.train_step_flops(
        tree, accum, b, 8, len(bow))


def test_flash_roofline_inputs_by_hand():
    """One forward and one backward at (bh, s, d) = (24, 1655, 128) in bf16."""
    bh, s, d = 24, 1655, 128
    assert flops.flash_forward(bh, s, d, 2) == (2 * 2 * bh * s * s * d, 4 * bh * s * d * 2)
    assert flops.flash_backward(bh, s, d, 2) == (5 * 2 * bh * s * s * d, 8 * bh * s * d * 2)
    f, by = flops.flash_forward(bh, s, d, 2)
    assert flops.least_seconds(f, by, 989e12, 3.35e12) == f / 989e12  # compute-bound
    tree = json_tree = tiny_tree((2, 2, 2))
    calls = flops.flash_calls(json_tree, 5)
    s_tiny = tree["data"]["n_timepoints"] + 4
    assert calls == [(4 * 5 * 2, s_tiny, 16)] * 3 + [(4 * 5 * 1, s_tiny, 32)] * 2
    assert flops.iir_bytes(10, 100) == 10 * 100 * 4 * 2
