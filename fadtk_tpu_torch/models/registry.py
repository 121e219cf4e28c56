"""Model registry: every variant the reference registers
(fadtk/model_loader.py:676-701), built lazily.

The 146 names of ``fadtk_tpu.models.registry``, in its order:

    clap-2023; clap-laion-audio, clap-laion-music; vggish;
    MERT-v1-95M[-1..11] (12 = default name); encodec-emb, encodec-emb-48k;
    w2v2-base[-1..11], w2v2-large[-1..23] (24 = default);
    hubert-base[-..], hubert-large[-..];
    wavlm-base[-..], wavlm-base-plus[-..], wavlm-large[-..];
    whisper-{tiny,small,base,medium,large}; dac-44kHz;
    cdpam-acoustic, cdpam-content.
"""

from __future__ import annotations

from typing import Callable

from .base import EmbeddingModel


def _builders() -> list[Callable[[], EmbeddingModel]]:
    from .cdpam import CdpamModel
    from .clap_laion import CLAPLaionModel
    from .clap_ms import MSCLAPModel
    from .dac import DACModel
    from .encodec import EncodecEmbModel
    from .hubert import HuBERTModel
    from .mert import MERTModel
    from .vggish import VGGishModel
    from .wav2vec2 import W2V2Model
    from .wavlm import WavLMModel
    from .whisper import WhisperModel

    builders: list[Callable[[], EmbeddingModel]] = [
        lambda: MSCLAPModel("2023"),
        lambda: CLAPLaionModel("audio"),
        lambda: CLAPLaionModel("music"),
        lambda: VGGishModel(),
    ]
    builders += [lambda v=v: MERTModel(layer=v) for v in range(1, 13)]
    builders += [lambda: EncodecEmbModel("24k"), lambda: EncodecEmbModel("48k")]
    builders += [lambda v=v: W2V2Model("base", layer=v) for v in range(1, 13)]
    builders += [lambda v=v: W2V2Model("large", layer=v) for v in range(1, 25)]
    builders += [lambda v=v: HuBERTModel("base", layer=v) for v in range(1, 13)]
    builders += [lambda v=v: HuBERTModel("large", layer=v) for v in range(1, 25)]
    builders += [lambda v=v: WavLMModel("base", layer=v) for v in range(1, 13)]
    builders += [lambda v=v: WavLMModel("base-plus", layer=v) for v in range(1, 13)]
    builders += [lambda v=v: WavLMModel("large", layer=v) for v in range(1, 25)]
    builders += [
        lambda s=s: WhisperModel(s) for s in ("tiny", "small", "base", "medium", "large")
    ]
    builders += [lambda: DACModel()]
    builders += [lambda: CdpamModel("acoustic"), lambda: CdpamModel("content")]
    return builders


def get_all_models() -> list[EmbeddingModel]:
    """All registered model variants."""
    return [b() for b in _builders()]


def get_model(name: str) -> EmbeddingModel:
    """Look up a single model variant by registry name."""
    for b in _builders():
        m = b()
        if m.name == name:
            return m
    raise KeyError(f"Unknown model: {name}")
