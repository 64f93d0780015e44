"""Seeding, metric loggers, tracing and step timing."""

from .metrics import JsonlLogger, MetricLogger, NullLogger, get_logger  # noqa: F401
from .rng import seed_everything  # noqa: F401
