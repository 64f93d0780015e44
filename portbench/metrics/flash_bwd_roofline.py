"""The fused flash backward's share of its roofline: the least time of the
backward calls of the traced steps (``portbench.flops``: five products,
Q, K, V, O and dO read once, dQ, dK, dV written once), over the device time
of the fused backward's kernels (``csrc/flash_bwd.cu``: ``flash_bwd_kernel``
and its Hopper and TF32 variants, found by name; the split kernels'
``flash_bwd_dq`` and ``flash_bwd_dkv`` are not these)."""

from portbench import flops
from portbench.peaks import HBM_BYTES_PER_S, PEAK_FLOPS
from portbench.trace import kernel_seconds

NAMES = ("flash_bwd_kernel", "flash_bwd_wgmma_kernel", "flash_bwd_tf32_kernel")


def read(layer: dict):
    if layer.get("summary") is None:
        return None
    calls = layer.get("flash_bwd_calls")
    measured = kernel_seconds(layer["summary"],
                              lambda n: any(k in n for k in NAMES)) if calls else 0.0
    if not measured:
        return None
    least = sum(flops.least_seconds(*flops.flash_backward(bh, s, d, layer["elem"]),
                                    PEAK_FLOPS[layer["dtype"]], HBM_BYTES_PER_S)
                for bh, s, d in calls)
    return 100.0 * least / measured
