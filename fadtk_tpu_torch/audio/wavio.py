"""Minimal RIFF/WAVE 16-bit PCM I/O in pure numpy.

The converted-audio cache stores mono 16-bit PCM wavs (reference fadtk/fad.py:160,
written by torchaudio with encoding=PCM_S/16-bit); this module reads and writes
that format without any native audio dependency. General-format *decode* (opus,
mp3, ...) lives in fadtk_tpu_torch.audio.decode (native libav library).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..utils import PathLike


def read_wav_int16(path: PathLike) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV file.

    Returns (data, sample_rate); data is int16 of shape (n,) for mono or
    (n, channels) otherwise — matching soundfile.read(dtype='int16') as used by
    the reference (fadtk/model_loader.py:64).
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if audio_format not in (1, 0xFFFE) or bits != 16:
        raise ValueError(f"{path}: only 16-bit PCM is supported (fmt={audio_format}, bits={bits})")

    x = np.frombuffer(data, dtype="<i2")
    if channels > 1:
        x = x.reshape(-1, channels)
    return x, sample_rate


#: Format tags of the sample formats ``wav_frames`` counts: PCM and IEEE float.
_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def wav_frames(path: PathLike) -> tuple[int, int] | None:
    """(frames, sample_rate) of a PCM or float RIFF/WAVE file, read from its
    chunk headers alone (no sample is read); None for any other file.

    Frames count as ``read_wav_int16`` counts them: the data chunk's bytes
    present in the file (a chunk cut short by the file's end counts what is
    there), whole blocks of ``block_align``; the last data chunk wins.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                return None
            size_left = f.seek(0, 2) - 12
            pos = 12
            fmt = None
            data_bytes = None
            while size_left >= 8:
                f.seek(pos)
                cid, size = struct.unpack("<4sI", f.read(8))
                if cid == b"fmt ":
                    fmt = f.read(min(size, 26))
                elif cid == b"data":
                    data_bytes = min(size, size_left - 8)
                step = 8 + size + (size & 1)
                pos += step
                size_left -= step
    except OSError:
        return None
    if fmt is None or len(fmt) < 16 or data_bytes is None:
        return None
    tag, _channels, sample_rate, _byte_rate, block_align, _bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == _EXTENSIBLE and len(fmt) >= 26:
        tag = struct.unpack("<H", fmt[24:26])[0]  # the sub-format GUID's first field
    if tag not in (_PCM, _FLOAT) or block_align == 0 or sample_rate == 0:
        return None
    return data_bytes // block_align, sample_rate


def write_wav_int16(path: PathLike, data: np.ndarray, sample_rate: int) -> None:
    """Write int16 PCM data of shape (n,) or (n, channels) as a WAV file."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        raise ValueError(f"expected int16 data, got {data.dtype}")
    channels = 1 if data.ndim == 1 else data.shape[1]
    payload = data.astype("<i2").tobytes()

    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, sample_rate,
        sample_rate * channels * 2, channels * 2, 16,
    )
    header += b"data" + struct.pack("<I", len(payload))

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header + payload)


def float_to_int16(x: np.ndarray) -> np.ndarray:
    """Float [-1, 1] -> int16 with clamping, matching torchaudio's PCM_S save
    semantics (scale by 32768, clamp to int16 range)."""
    y = np.asarray(x, dtype=np.float64) * 32768.0
    y = np.clip(np.rint(y), -32768, 32767)
    return y.astype(np.int16)
