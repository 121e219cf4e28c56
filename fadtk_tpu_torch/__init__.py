"""fadtk-tpu-torch: the PyTorch/CUDA port of ``fadtk_tpu``.

A second package beside the JAX one, which stays the reference it is tested
against. It imports torch and never jax, keeps the JAX package's environment
variables and on-disk layout (``convert/``, ``embeddings/``, ``stats/``, f16
``.npy``, ``<model>-bf16`` cache keys, the ``.npz`` weight store), and runs on
the device ``FADTK_TPU_TORCH_DEVICE`` names (default ``cuda``).

- ``fadtk_tpu_torch.audio``    — WAV I/O and decode (numpy; libav for other formats).
- ``fadtk_tpu_torch.dsp``      — the host Kaiser-sinc resampler, BS.1770 loudness meter and the
  VGGish / Whisper / torchlibrosa (CLAP) log-mel frontends.
- ``fadtk_tpu_torch.models``   — the whole registry (146 variants): the speech encoder (w2v2,
  HuBERT, WavLM, MERT), the codec encoders (EnCodec 24k/48k, DAC), VGGish, Whisper, HTSAT
  (CLAP) and CDPAM as ``nn.Module``s.
- ``fadtk_tpu_torch.ops``      — hand-written CUDA kernels beside their plain twins.
- ``fadtk_tpu_torch.metric``   — host statistics, the Frechet distance and device scoring
  (the FAD-inf sweep, per-song FAD).
- ``fadtk_tpu_torch.parallel`` — the (dp, tp) process mesh, the tensor-parallel speech step
  and the chunked / whole-clip data-parallel pipeline of the other families.
- ``fadtk_tpu_torch.runner``   — cache layout, batched embedding, scoring, the device
  pipeline.
- ``fadtk_tpu_torch.cli``      — ``python -m fadtk_tpu_torch`` and its ``.embeds``,
  ``.package`` and ``.test`` siblings.

Public API mirrors the JAX package's facade (and so the reference's,
fadtk/__init__.py:1-3).
"""

from .metric.frechet import calc_frechet_distance, frechet_distance
from .metric.stats import calc_embd_statistics, calculate_embd_statistics_online
from .runner.fad import FADInfResults, FrechetAudioDistance
from .runner.batch import cache_embedding_files, cache_embedding_files_multi
from .models.base import EmbeddingModel
from .models.registry import get_all_models, get_model
from .models.cdpam import CdpamModel
from .models.clap_laion import CLAPLaionModel
from .models.clap_ms import MSCLAPModel
from .models.dac import DACModel
from .models.encodec import EncodecEmbModel
from .models.hubert import HuBERTModel
from .models.mert import MERTModel
from .models.vggish import VGGishModel
from .models.wav2vec2 import W2V2Model
from .models.wavlm import WavLMModel
from .models.whisper import WhisperModel
from .utils import PathLike, find_sox_formats, get_cache_embedding_path, log, resolve_device
from .fad import TORCHAUDIO_RESAMPLING, ffmpeg_path, sox_path, torchaudio_backend

# Reference names (the reference star-exports its whole surface): its ABC is
# `ModelLoader` (model_loader.py:21) and its msclap wrapper `CLAPModel`
# (model_loader.py:463).
ModelLoader = EmbeddingModel
CLAPModel = MSCLAPModel

__version__ = "0.1.0"

__all__ = [
    "frechet_distance",
    "calc_frechet_distance",
    "calc_embd_statistics",
    "calculate_embd_statistics_online",
    "FrechetAudioDistance",
    "FADInfResults",
    "cache_embedding_files",
    "cache_embedding_files_multi",
    "EmbeddingModel",
    "ModelLoader",
    "get_all_models",
    "get_model",
    "CdpamModel",
    "CLAPLaionModel",
    "MSCLAPModel",
    "CLAPModel",
    "DACModel",
    "EncodecEmbModel",
    "HuBERTModel",
    "MERTModel",
    "VGGishModel",
    "W2V2Model",
    "WavLMModel",
    "WhisperModel",
    "get_cache_embedding_path",
    "find_sox_formats",
    "PathLike",
    "log",
    "resolve_device",
    "TORCHAUDIO_RESAMPLING",
    "sox_path",
    "ffmpeg_path",
    "torchaudio_backend",
    "__version__",
]
