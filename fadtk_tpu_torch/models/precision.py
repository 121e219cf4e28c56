"""bf16 throughput mode.

Every model's compute dtype follows its parameter dtype, so casting the loaded
module to bfloat16 turns on the fast path: GEMMs and convs run on bf16 tensor
cores, attention takes the hand-written flash kernel
(``ops/flash_attention.py``), and GELU takes the tanh approximation. The policy
is the JAX package's (``fadtk_tpu/models/precision.py``), kept so the port's
bf16 embeddings stay close to its:

- norm statistics (LayerNorm, the masked GroupNorm's sums, EnCodec 48k's
  one-pass time group norm moments), attention logits and softmax stay
  float32; the codec families' ELU, snake (``torch.sin``) and LSTM simply
  run in the weights' dtype, as in the JAX package;
- opt-in only: env ``FADTK_TPU_BF16=1`` or the ``--bf16`` CLI flag;
- bf16 embeddings differ slightly from the float32 reference-parity values, so
  caches and stats segregate under ``<model>-bf16`` names
  (``EmbeddingModel.cache_name``);
- scoring itself is unchanged (host float64 Frechet on the cached float16
  embeddings).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

_TRUTHY = ("1", "true", "yes", "on")


def bf16_enabled() -> bool:
    """Is the global bf16 throughput mode requested (FADTK_TPU_BF16)?"""
    return os.environ.get("FADTK_TPU_BF16", "").strip().lower() in _TRUTHY


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the precision-mode-matched approximation policy.

    float32 (the parity path) keeps the exact erf form the HF models use,
    ``0.5·x·(1 + erf(x/√2))``; bfloat16 uses the tanh approximation, whose
    <=3e-4 absolute error is an order below bf16's own rounding.
    """
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)
