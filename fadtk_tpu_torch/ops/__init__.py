"""Hand-written CUDA kernels for the hot model ops, each beside its plain twin."""

from .flash_attention import (
    flash_attention_enabled,
    flash_attention_packed,
    flash_attention_packed_reference,
)

__all__ = [
    "flash_attention_enabled",
    "flash_attention_packed",
    "flash_attention_packed_reference",
]
