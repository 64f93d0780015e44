"""Attention (the dispatching wrapper and the flash CUDA kernels), the
dropout keep-mask and the dropout randomness."""

from .attention import dot_product_attention, flash_route  # noqa: F401
from .dropout_mask import dropout_keep_mask_reference, tile_keep_mask  # noqa: F401
from .flash_attention import flash_attention, flash_attention_reference  # noqa: F401
from .random import dropout  # noqa: F401
