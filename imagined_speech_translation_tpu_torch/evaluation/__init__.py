"""Chinese text-generation evaluation: a jax-free copy of the JAX package's
``evaluation.evaluator``."""

from .evaluator import ChineseEvaluator, prediction_diversity  # noqa: F401
