"""Kaiser-windowed sinc polyphase resampler (host, numpy/BLAS).

Numerically equivalent to torchaudio's ``sinc_interp_kaiser`` resampler with the
exact constants the reference pins for SoX-HQ parity (reference
fadtk/fad.py:151-158): ``lowpass_filter_width=64``,
``rolloff=0.9475937167399596``, ``beta=14.769656459379492``.

This is the host half of ``fadtk_tpu.dsp.resample``, kept line for line so that
``resample_kaiser`` is bit-identical to it (tests/test_torch_host.py): the same
gcd reduction, index grid, Kaiser window (i0), edge padding
(width, width + orig) and ceil-based output length as torchaudio.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
from scipy.special import i0 as _i0

# Reference resampling constants (fadtk/fad.py:154-157).
LOWPASS_FILTER_WIDTH = 64
ROLLOFF = 0.9475937167399596
KAISER_BETA = 14.769656459379492


@lru_cache(maxsize=64)
def kaiser_sinc_kernel(
    sr_in: int,
    sr_out: int,
    lowpass_filter_width: int = LOWPASS_FILTER_WIDTH,
    rolloff: float = ROLLOFF,
    beta: float = KAISER_BETA,
) -> tuple[np.ndarray, int, int, int]:
    """Build the polyphase kernel.

    Returns (kernels, width, orig, new) where kernels has shape
    (new, 2*width + orig) — one FIR per output phase — and orig/new are the
    gcd-reduced rates. Mirrors torchaudio's `_get_sinc_resample_kernel` math,
    computed in float64 then cast to float32 (float64 construction only
    reduces rounding noise below the 16-bit PCM quantization that follows in
    the cache, fadtk/fad.py:160).
    """
    gcd = math.gcd(int(sr_in), int(sr_out))
    orig = int(sr_in) // gcd
    new = int(sr_out) // gcd

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    # t[p, k] = (-p/new + (k - width)/orig) * base_freq, p in [0, new), k taps.
    idx = np.arange(-width, width + orig, dtype=np.float64) / orig  # (K,)
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = _i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / _i0(beta)
    tpi = t * math.pi
    scale = base_freq / orig
    kernels = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width, orig, new


def resample_kaiser(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample waveforms on the host (numpy/BLAS). Identity when rates match.

    The polyphase application is a framed GEMM — (n_blocks, K) windows x
    (K, new) filters — executed by BLAS sgemm in bounded chunks, so the
    decode threads scale it across cores.
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    kernels, width, orig, new = kaiser_sinc_kernel(int(sr_in), int(sr_out))
    x = np.asarray(x, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    b, length = x.shape
    xp = np.pad(x, ((0, 0), (width, width + orig)))
    taps = kernels.shape[1]
    n_blocks = (xp.shape[1] - taps) // orig + 1
    if taps > 8 * orig:
        # Small-orig ratios (48k->24k, 44.1k->22.05k: orig=2, taps=274) make
        # the window matrix a taps/orig ~ 137x data amplification, so the GEMM
        # is copy-bound there. Few phases (new <= orig) means per-phase
        # overlap-add FFT convolution wins:
        # y[m*new + p] = (xp * kernels[p])[m*orig + taps - 1]. Identical math
        # to FFT roundoff (~1e-7, far below the 16-bit PCM quantization that
        # follows).
        from scipy.signal import oaconvolve

        out = np.empty((b, n_blocks * new), np.float32)
        for p in range(new):
            conv = oaconvolve(xp, kernels[p : p + 1, ::-1], axes=-1)
            out[:, p::new] = conv[
                :, taps - 1 : taps - 1 + n_blocks * orig : orig
            ].astype(np.float32, copy=False)
    else:
        # (b, n_blocks, taps) strided view; GEMM chunks bound the materialized
        # copy to ~32 MB. The explicit copy before each GEMM is load-bearing:
        # numpy's matmul on the strided window view falls off the BLAS path.
        windows = np.lib.stride_tricks.sliding_window_view(xp, taps, axis=1)[:, ::orig]
        kt = kernels.T  # (taps, new)
        out = np.empty((b, n_blocks * new), np.float32)
        chunk = max(1, (1 << 23) // max(taps, 1))
        for s in range(0, n_blocks, chunk):
            e = min(s + chunk, n_blocks)
            block = np.ascontiguousarray(windows[:, s:e])
            out[:, s * new : e * new] = (block @ kt).reshape(b, -1)
    target_len = int(math.ceil(new * length / orig))
    y = out[:, :target_len]
    return y[0] if squeeze else y


def resampled_length(n: int, sr_in: int, sr_out: int) -> int:
    """Output length of resampling an n-sample clip (torchaudio's ceil rule)."""
    gcd = math.gcd(int(sr_in), int(sr_out))
    return int(math.ceil((sr_out // gcd) * n / (sr_in // gcd)))
