"""Audio decode: ``decode_audio(path) -> (data, sample_rate)``, data float32 of
shape ``(channels, n_frames)`` — torchaudio.load's convention, which the
reference's mono downmix (mean over axis 0, fadtk/fad.py:149-150) expects.

Two routes:

- 16-bit PCM WAV is read in numpy as int16 / 32768. That is bit-identical to
  what libav's s16 -> float conversion returns for such a file
  (tests/test_torch_host.py pins it against ``fadtk_tpu.audio.decode``), and
  it needs no native library, so the common convert-cache input decodes on
  machines without FFmpeg development files.
- Every other format goes through the port's native libav decoder
  (``fadtk_tpu_torch/native/decode.cc``), loaded by path with ctypes at first
  use. ``fadtk_tpu_torch/native/build.sh`` builds it into
  ``build/fadtk_tpu_torch/`` (again whenever the source is newer than the
  library). ``FADTK_TPU_NATIVE_LIB`` names a prebuilt library instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils import PathLike, log
from .wavio import read_wav_int16

_REPO = Path(__file__).resolve().parents[2]
_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_BUILD_DIR = _REPO / "build" / "fadtk_tpu_torch"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _library_path() -> Path:
    env = os.environ.get("FADTK_TPU_NATIVE_LIB")
    if env:
        return Path(env)
    out = _BUILD_DIR / "libfadtk_audio.so"
    if out.exists() and out.stat().st_mtime >= (_NATIVE_DIR / "decode.cc").stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    log.info("Building native audio decoder (libav)...")
    try:
        subprocess.run(
            ["sh", str(_NATIVE_DIR / "build.sh"), str(out)],
            check=True, capture_output=True, text=True,
        )
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(
            "cannot build the libav audio decoder needed for non-WAV input "
            f"(g++ and the FFmpeg development libraries libavformat, libavcodec, "
            f"libavutil and libswresample are required): {detail.strip()}"
        ) from e
    return out


def _get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_library_path()))
        lib.fadtk_decode_audio.restype = ctypes.c_int
        lib.fadtk_decode_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.fadtk_free.restype = None
        lib.fadtk_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _LIB = lib
        return lib


def _decode_pcm16_wav(path: Path) -> tuple[np.ndarray, int] | None:
    """(channels, n) float32 for a 16-bit PCM WAV, None for any other file."""
    try:
        data, sr = read_wav_int16(path)
    except ValueError:  # not RIFF/WAVE, or float / 24-bit / compressed WAV
        return None
    data = np.ascontiguousarray(data.reshape(data.shape[0], -1).T, np.float32)
    return data / np.float32(32768.0), sr


def _decode_libav(path: Path) -> tuple[np.ndarray, int]:
    lib = _get_lib()
    data = ctypes.POINTER(ctypes.c_float)()
    channels = ctypes.c_int()
    frames = ctypes.c_longlong()
    sr = ctypes.c_int()
    err = ctypes.create_string_buffer(512)

    rc = lib.fadtk_decode_audio(
        str(path).encode(), ctypes.byref(data), ctypes.byref(channels),
        ctypes.byref(frames), ctypes.byref(sr), err, len(err),
    )
    if rc != 0:
        raise RuntimeError(f"decode failed for {path}: {err.value.decode(errors='replace')}")

    try:
        n = frames.value * channels.value
        flat = np.ctypeslib.as_array(data, shape=(n,)).copy()
    finally:
        lib.fadtk_free(data)

    # interleaved -> (channels, frames)
    return flat.reshape(frames.value, channels.value).T.copy(), sr.value


def decode_audio(path: PathLike) -> tuple[np.ndarray, int]:
    """Decode an audio file to (channels, n_frames) float32 + sample rate."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    wav = _decode_pcm16_wav(path)
    return wav if wav is not None else _decode_libav(path)
