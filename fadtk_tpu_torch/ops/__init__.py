"""Hand-written CUDA kernels for the hot model ops, each beside its plain twin.

The head-major flash attention (K2) and the fused log-mel kernel (K3) are
reached through their modules, ``fadtk_tpu_torch.ops.flash_attention`` and
``fadtk_tpu_torch.ops.fused_log_mel``, whose names their functions share:
exporting ``flash_attention`` here, as the JAX package's ``ops`` does, would
shadow the module that holds K1 and every kernel's launch counters."""

from .flash_attention import (
    flash_attention_enabled,
    flash_attention_packed,
    flash_attention_packed_reference,
    flash_attention_reference,
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
    "flash_attention_reference",
    "fused_resnet_causal",
    "fused_resnet_causal_reference",
    "fused_resnet_enabled",
]
