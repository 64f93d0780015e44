"""Greedy / beam search and the EEG -> tokens generate function."""

from .generate import build_bart_generate_fn, build_generate_fn  # noqa: F401
from .search import DecodeParams, beam_search, greedy_search  # noqa: F401
