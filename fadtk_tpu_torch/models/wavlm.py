"""WavLM embedding models.

Registry parity: reference fadtk/model_loader.py:599-633 — `wavlm-base[-L]`,
`wavlm-base-plus[-L]`, `wavlm-large[-L]`. NOTE the reference's checkpoints are
the community fine-tunes patrickvonplaten/wavlm-libri-clean-100h-{size}
(fadtk/model_loader.py:610), not microsoft/wavlm-* — preserved here for score
parity. 16 kHz, 6-minute truncation, gated relative-position-bias attention.

Defaults are overridden by conversion-time metadata stored with the weights.
"""

from __future__ import annotations

from .speech.config import base_config, large_config
from .speech.family import SpeechEmbeddingModel


class WavLMModel(SpeechEmbeddingModel):
    def __init__(self, size: str, layer: int, limit_minutes: int = 6):
        assert size in ("base", "base-plus", "large")
        model_dim = 768 if size in ("base", "base-plus") else 1024
        default_layer = 12 if size in ("base", "base-plus") else 24
        name = f"wavlm-{size}" + ("" if layer == default_layer else f"-{layer}")

        common = dict(attention_type="wavlm", num_buckets=320, max_bucket_distance=800)
        if size in ("base", "base-plus"):
            cfg = base_config(do_normalize=False, **common)
        else:
            cfg = large_config(
                feat_extract_norm="layer",
                do_stable_layer_norm=True,
                conv_bias=True,
                do_normalize=True,
                **common,
            )

        super().__init__(
            name=name,
            num_features=model_dim,
            sr=16000,
            cfg=cfg,
            layer=layer,
            hf_source=f"patrickvonplaten/wavlm-libri-clean-100h-{size}",
            limit_minutes=limit_minutes,
        )
