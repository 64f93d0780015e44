"""The training step's share of the card's peak: the benchmark's operation
count of an optimizer step (``portbench.flops``: forward, and backward at
twice its products) times the steps of the traced run's untraced stretch,
over that stretch's seconds on the host's clock (the profiler's host cost
would slow the host-paced step), over the dense peak of the compute
dtype."""

from portbench.peaks import PEAK_FLOPS


def read(layer: dict):
    if not layer.get("steps") or not layer.get("untraced_s"):
        return None
    rate = layer["flops_per_step"] * layer["steps"] / layer["untraced_s"]
    return 100.0 * rate / PEAK_FLOPS[layer["dtype"]]
