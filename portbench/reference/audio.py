"""Plain reference of the audio front of the pipeline: WAV decode, the mono
mean, the Kaiser-windowed sinc resample and the 16-bit PCM quantisation of
the converted clip, in float64.

Written from the published definitions, not from the program:

- RIFF/WAVE 16-bit PCM: little-endian int16 frames, channels interleaved,
  scaled by 1/32768;
- the mono downmix is the mean over channels (fadtk/fad.py:150);
- the resample is torchaudio's ``sinc_interp_kaiser`` (torchaudio.functional
  .resample: rates reduced by their gcd, ``base_freq = min(orig, new) *
  rolloff``, ``width = ceil(lowpass_filter_width * orig / base_freq)``, a
  Kaiser window ``i0(beta sqrt(1 - (t / lpw)^2)) / i0(beta)`` on the
  clamped sinc, the input padded by (width, width + orig), output length
  ``ceil(new * n / orig)``) with the constants fadtk pins for SoX-HQ parity
  (fadtk/fad.py:151-158): width 64, rolloff 0.9475937167399596, beta
  14.769656459379492;
- the converted clip is stored as 16-bit PCM: ``clip(rint(32768 x), -32768,
  32767) / 32768``.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np
import torch

LOWPASS_FILTER_WIDTH = 64
ROLLOFF = 0.9475937167399596
KAISER_BETA = 14.769656459379492


def read_wav(path: Path) -> tuple[np.ndarray, int]:
    """(channels, n) float64 samples in [-1, 1) and the sample rate."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not RIFF/WAVE")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", raw[pos + 8:pos + 24])
        elif cid == b"data":
            data = raw[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    if fmt is None or data is None or fmt[0] != 1 or fmt[5] != 16:
        raise ValueError(f"{path}: not 16-bit PCM")
    channels, sr = fmt[1], fmt[2]
    x = np.frombuffer(data, "<i2").reshape(-1, channels).T.astype(np.float64) / 32768.0
    return x, sr


def _kernels(sr_in: int, sr_out: int, device) -> tuple[torch.Tensor, int, int, int]:
    g = math.gcd(sr_in, sr_out)
    orig, new = sr_in // g, sr_out // g
    base_freq = min(orig, new) * ROLLOFF
    width = math.ceil(LOWPASS_FILTER_WIDTH * orig / base_freq)
    f64 = dict(dtype=torch.float64, device=device)
    idx = torch.arange(-width, width + orig, **f64) / orig
    t = torch.arange(0, -new, -1, **f64)[:, None] / new + idx[None, :]
    t = torch.clamp(t * base_freq, -LOWPASS_FILTER_WIDTH, LOWPASS_FILTER_WIDTH)
    window = torch.special.i0(KAISER_BETA * torch.sqrt(1 - (t / LOWPASS_FILTER_WIDTH) ** 2))
    window = window / torch.special.i0(torch.tensor(KAISER_BETA, **f64))
    tpi = t * math.pi
    sinc = torch.where(tpi == 0, torch.ones_like(tpi), torch.sin(tpi) / torch.where(
        tpi == 0, torch.ones_like(tpi), tpi))
    return sinc * window * (base_freq / orig), width, orig, new


def resample(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """(n,) float64 -> (ceil(n sr_out / sr_in),) float64, where ``x`` lies."""
    if sr_in == sr_out:
        return x
    k, width, orig, new = _kernels(sr_in, sr_out, x.device)
    n = x.shape[0]
    xp = torch.nn.functional.pad(x[None, None], (width, width + orig))
    y = torch.nn.functional.conv1d(xp, k[:, None, :], stride=orig)  # (1, new, blocks)
    return y[0].T.reshape(-1)[: math.ceil(new * n / orig)]


def converted_clip(path: Path, sr_out: int, device) -> torch.Tensor:
    """The model-rate clip the pipeline should embed, float64 on ``device``."""
    x, sr = read_wav(path)
    mono = torch.from_numpy(x.mean(axis=0)).to(device)
    y = resample(mono, sr, sr_out)
    return torch.clamp(torch.round(y * 32768.0), -32768.0, 32767.0) / 32768.0
