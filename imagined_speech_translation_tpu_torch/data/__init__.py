"""Jax-free copies of the JAX package's host data plane: region layout,
tokenizer, Chisco corpus, robust scaler, the dataset and its split, and the
synthetic corpus; and the device feed (``feed.py``: pinned memory and a
side CUDA stream)."""

from .regions import REGION_NAMES, RegionSpec, load_montage  # noqa: F401
from .scaler import RegionRobustScaler  # noqa: F401
from .tokenizer import ChineseCharTokenizer, WordPieceTokenizer  # noqa: F401
from .chisco import ChiscoCorpus, validate_sample  # noqa: F401
from .dataset import EEGTextDataset, split_indices  # noqa: F401
from .synthetic import make_synthetic_corpus, make_synthetic_montage  # noqa: F401
from .feed import batch_iterator, device_prefetch, threaded_producer  # noqa: F401
