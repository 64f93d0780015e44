"""The IIR kernel's share of its roofline: the bytes of the traced
window's series (float32, each sample read once and written once) over the
memory bandwidth, over the device time of ``csrc/sosfilt.cu``'s kernel."""

from portbench import flops
from portbench.peaks import HBM_BYTES_PER_S
from portbench.trace import kernel_seconds


def read(layer: dict):
    if layer.get("summary") is None:
        return None
    rows = layer.get("iir_rows")
    measured = kernel_seconds(layer["summary"], lambda n: "sosfilt" in n) if rows else 0.0
    if not measured:
        return None
    return 100.0 * flops.iir_bytes(rows, layer["length"]) / HBM_BYTES_PER_S / measured
