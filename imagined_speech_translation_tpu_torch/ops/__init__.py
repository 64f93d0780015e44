"""Attention: the dispatching wrapper and the flash-forward CUDA kernel."""

from .attention import dot_product_attention, flash_route  # noqa: F401
from .flash_attention import flash_attention, flash_attention_reference  # noqa: F401
