"""fadtk-tpu-torch: the PyTorch/CUDA port of ``fadtk_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against. It imports torch and never jax, keeps the JAX package's environment
variables and on-disk layout (``convert/``, ``embeddings/``, ``stats/``, f16
``.npy``, ``<model>-bf16`` cache keys, the ``.npz`` weight store), and runs on
the device ``FADTK_TPU_TORCH_DEVICE`` names (default ``cuda``).

- ``fadtk_tpu_torch.audio``   — WAV I/O and decode (numpy; libav for other formats).
- ``fadtk_tpu_torch.dsp``     — the host Kaiser-sinc resampler, BS.1770 loudness meter and the
  VGGish / Whisper log-mel frontends.
- ``fadtk_tpu_torch.models``  — the speech encoder (w2v2, HuBERT, WavLM, MERT), the codec
  encoders (EnCodec 24k/48k, DAC), VGGish and Whisper as ``nn.Module``s + registry.
- ``fadtk_tpu_torch.ops``     — hand-written CUDA kernels beside their plain twins.
- ``fadtk_tpu_torch.metric``  — host statistics and the Frechet distance.
- ``fadtk_tpu_torch.runner``  — cache layout, batched embedding, scoring.
- ``fadtk_tpu_torch.cli``     — ``python -m fadtk_tpu_torch``.
"""

from .metric.frechet import frechet_distance
from .metric.stats import calc_embd_statistics, calculate_embd_statistics_online
from .models.base import EmbeddingModel
from .models.registry import get_all_models, get_model
from .models.wav2vec2 import W2V2Model
from .runner.batch import cache_embedding_files
from .runner.fad import FrechetAudioDistance
from .utils import PathLike, get_cache_embedding_path, log, resolve_device

__version__ = "0.1.0"

__all__ = [
    "frechet_distance",
    "calc_embd_statistics",
    "calculate_embd_statistics_online",
    "EmbeddingModel",
    "get_all_models",
    "get_model",
    "W2V2Model",
    "cache_embedding_files",
    "FrechetAudioDistance",
    "PathLike",
    "get_cache_embedding_path",
    "log",
    "resolve_device",
    "__version__",
]
