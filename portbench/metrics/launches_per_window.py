"""Kernel launches of the traced window (device kernel records) over the
windows it decoded: a count, which repeats exactly."""


def read(layer: dict):
    if layer.get("summary") is None:
        return None
    if not layer.get("windows"):
        return None
    return layer["summary"]["launches"] / layer["windows"]
