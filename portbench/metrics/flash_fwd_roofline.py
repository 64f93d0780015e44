"""The flash forward's share of its roofline: the least time of the
forward calls the traced window's work needs (``portbench.flops``: the
larger of operations over the dense peak and bytes over the memory
bandwidth, Q, K and V read once, O written once), over the device time of
the kernels the forward launches (``csrc/flash_fwd.cu``, found by name)."""

from portbench import flops
from portbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from portbench.trace import kernel_seconds


def read(layer: dict):
    if layer.get("summary") is None:
        return None
    calls = layer.get("flash_calls")
    measured = kernel_seconds(layer["summary"], lambda n: "flash_fwd" in n) if calls else 0.0
    if not measured:
        return None
    least = sum(flops.least_seconds(*flops.flash_forward(bh, s, d, layer["elem"]),
                                    PEAK_FLOPS[layer["dtype"]], HBM_BYTES_PER_S)
                for bh, s, d in calls)
    return 100.0 * least / measured
