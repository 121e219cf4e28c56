"""Module-path parity with ``fadtk.model_loader`` (reference
fadtk/model_loader.py).

Reference users import the model classes and the registry from this path
(model_loader.py public names :21,89,111,189,254,291,421,463,525,562,599,
636,676). The implementations live under ``models/``; the reference's ABC
``ModelLoader`` is ``EmbeddingModel`` and its msclap wrapper ``CLAPModel``
is ``MSCLAPModel``, as in the package's own namespace.
"""

from .models.base import EmbeddingModel as ModelLoader
from .models.cdpam import CdpamModel
from .models.clap_laion import CLAPLaionModel
from .models.clap_ms import MSCLAPModel as CLAPModel
from .models.dac import DACModel
from .models.encodec import EncodecEmbModel
from .models.hubert import HuBERTModel
from .models.mert import MERTModel
from .models.registry import get_all_models, get_model
from .models.vggish import VGGishModel
from .models.wav2vec2 import W2V2Model
from .models.wavlm import WavLMModel
from .models.whisper import WhisperModel
from .utils import log

__all__ = [
    "log",
    "ModelLoader",
    "VGGishModel",
    "EncodecEmbModel",
    "DACModel",
    "MERTModel",
    "CLAPLaionModel",
    "CdpamModel",
    "CLAPModel",
    "W2V2Model",
    "HuBERTModel",
    "WavLMModel",
    "WhisperModel",
    "get_all_models",
    "get_model",
]
