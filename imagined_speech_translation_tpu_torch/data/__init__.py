"""Jax-free copies of the JAX package's region layout and tokenizer."""

from .regions import REGION_NAMES, RegionSpec, load_montage  # noqa: F401
from .tokenizer import ChineseCharTokenizer, WordPieceTokenizer  # noqa: F401
