"""The share of the untraced stretch in which the card ran nothing: 1 -
the card's busy seconds (the union of kernel, copy and memset intervals,
``portbench.trace.device_summary``) of the traced block, over the seconds
of the same work untraced on the host's clock.  The traced span itself is
stretched by the profiler's host cost, so it is not the divisor."""


def read(layer: dict):
    s = layer.get("summary")
    if not s or not s["busy_s"] or not layer.get("untraced_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / layer["untraced_s"])
