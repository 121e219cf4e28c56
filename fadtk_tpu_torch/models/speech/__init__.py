from .config import SpeechEncoderConfig
from .encoder import SpeechEncoder, init_speech_encoder, speech_encoder_forward

__all__ = ["SpeechEncoder", "SpeechEncoderConfig", "init_speech_encoder", "speech_encoder_forward"]
