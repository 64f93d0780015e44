"""Seeding, metric loggers, tracing, step timing and the kernels' build cache."""

from .metrics import JsonlLogger, MetricLogger, NullLogger, get_logger  # noqa: F401
from .rng import RngStream, seed_everything  # noqa: F401
