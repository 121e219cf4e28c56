from .wavio import read_wav_int16, write_wav_int16

__all__ = ["read_wav_int16", "write_wav_int16"]
