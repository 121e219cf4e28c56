"""Hand-written CUDA kernels for the hot model ops, each beside its plain twin.

The fused log-mel kernel (K3) is imported as its module,
``fadtk_tpu_torch.ops.fused_log_mel``, whose name its function shares."""

from .flash_attention import (
    flash_attention_enabled,
    flash_attention_packed,
    flash_attention_packed_reference,
)
from .fused_resnet import (
    fused_resnet_causal,
    fused_resnet_causal_reference,
    fused_resnet_enabled,
)

__all__ = [
    "flash_attention_enabled",
    "flash_attention_packed",
    "flash_attention_packed_reference",
    "fused_resnet_causal",
    "fused_resnet_causal_reference",
    "fused_resnet_enabled",
]
