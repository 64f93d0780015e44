"""Serving runtime: the cross-session batch scheduler."""

from .batcher import BatchScheduler, LatencyStats  # noqa: F401
