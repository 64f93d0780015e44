"""The whole decode function's share of the card's peak: the benchmark's
operation count of a served window (``portbench.flops``) times the windows
of the traced run's untraced stretch, over that stretch's seconds on the
host's clock (the profiler's host cost would slow the host-paced decode),
over the dense peak of the serving dtype."""

from portbench.peaks import PEAK_FLOPS


def read(layer: dict):
    if not layer.get("windows") or not layer.get("untraced_s"):
        return None
    rate = layer["flops_per_window"] * layer["windows"] / layer["untraced_s"]
    return 100.0 * rate / PEAK_FLOPS[layer["dtype"]]
