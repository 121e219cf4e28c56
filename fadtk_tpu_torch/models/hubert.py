"""HuBERT embedding models.

Registry parity: reference fadtk/model_loader.py:562-596 — `hubert-base[-L]` /
`hubert-large[-L]`, checkpoints facebook/hubert-{size}-ls960, 16 kHz, 6-minute
truncation. The reference loads the *processor* from
facebook/hubert-large-ls960-ft for both sizes (fadtk/model_loader.py:581),
which normalizes input — so do_normalize=True here for both.

Defaults are overridden by conversion-time metadata stored with the weights.
"""

from __future__ import annotations

from .speech.config import base_config, large_config
from .speech.family import SpeechEmbeddingModel


class HuBERTModel(SpeechEmbeddingModel):
    def __init__(self, size: str, layer: int, limit_minutes: int = 6):
        assert size in ("base", "large")
        model_dim = 768 if size == "base" else 1024
        default_layer = 12 if size == "base" else 24
        name = f"hubert-{size}" + ("" if layer == default_layer else f"-{layer}")

        if size == "base":
            cfg = base_config(do_normalize=True)
        else:
            # hubert-large-ls960 (pretrained): layer-norm convs, pre-norm encoder.
            cfg = large_config(
                feat_extract_norm="layer",
                do_stable_layer_norm=True,
                conv_bias=True,
                do_normalize=True,
            )

        super().__init__(
            name=name,
            num_features=model_dim,
            sr=16000,
            cfg=cfg,
            layer=layer,
            hf_source=f"facebook/hubert-{size}-ls960",
            limit_minutes=limit_minutes,
        )
