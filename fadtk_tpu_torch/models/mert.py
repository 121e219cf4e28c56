"""MERT music embedding models.

Registry parity: reference fadtk/model_loader.py:254-288 — `MERT-v1-95M` plus
per-layer variants `MERT-v1-95M-{1..11}` (12 = default name), checkpoint
m-a-p/MERT-v1-95M, 24 kHz, 768 features.

MERT-v1-95M is a HuBERT-style encoder trained on music; the reference forces
``conv_pos_batch_norm=False`` (fadtk/model_loader.py:270), i.e. the standard
weight-normed positional conv this family implements. The 6-minute truncation
(despite the reference's warning text saying 9, fadtk/model_loader.py:260,277)
is preserved. Defaults are overridden by conversion-time metadata.
"""

from __future__ import annotations

from .speech.config import base_config
from .speech.family import SpeechEmbeddingModel


class MERTModel(SpeechEmbeddingModel):
    def __init__(self, size: str = "v1-95M", layer: int = 12, limit_minutes: int = 6):
        name = f"MERT-{size}" + ("" if layer == 12 else f"-{layer}")
        super().__init__(
            name=name,
            num_features=768,
            sr=24000,
            cfg=base_config(do_normalize=True),
            layer=layer,
            hf_source=f"m-a-p/MERT-{size}",
            limit_minutes=limit_minutes,
        )
