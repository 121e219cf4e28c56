"""wav2vec 2.0 embedding models.

Registry parity: reference fadtk/model_loader.py:525-559 — `w2v2-base[-L]`
(L in 1..11, 12 = default name) and `w2v2-large[-L]` (L in 1..23, 24 = default),
checkpoints facebook/wav2vec2-{size}-960h, 16 kHz, 6-minute truncation.

Architecture defaults below describe the published 960h checkpoints (group-norm
conv extractor, post-norm encoder); they are overridden by conversion-time
metadata stored with the weights, so a converted checkpoint is always
self-describing.
"""

from __future__ import annotations

from .speech.config import base_config, large_config
from .speech.family import SpeechEmbeddingModel


class W2V2Model(SpeechEmbeddingModel):
    def __init__(self, size: str, layer: int, limit_minutes: int = 6):
        assert size in ("base", "large")
        model_dim = 768 if size == "base" else 1024
        default_layer = 12 if size == "base" else 24
        name = f"w2v2-{size}" + ("" if layer == default_layer else f"-{layer}")

        if size == "base":
            # facebook/wav2vec2-base-960h: its HF processor does NOT normalize.
            cfg = base_config(do_normalize=False)
        else:
            # facebook/wav2vec2-large-960h: group-norm/post-norm large; its HF
            # processor normalizes input.
            cfg = large_config(do_normalize=True)

        super().__init__(
            name=name,
            num_features=model_dim,
            sr=16000,
            cfg=cfg,
            layer=layer,
            hf_source=f"facebook/wav2vec2-{size}-960h",
            limit_minutes=limit_minutes,
        )
