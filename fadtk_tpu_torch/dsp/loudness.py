"""ITU-R BS.1770-4 integrated loudness (LUFS) in pure numpy.

The port's own copy of ``fadtk_tpu/dsp/loudness.py`` (same arithmetic, so the
same bits on the CPU). Needed by the DAC preprocessing path: the reference
normalizes input audio to -16 dB LUFS via audiotools (reference
fadtk/model_loader.py:222), whose Meter is a port of pyloudnorm — the same
algorithm implemented here:

- K-weighting: stage-1 high-shelf + stage-2 high-pass biquads (coefficients
  per the standard at 48 kHz, re-derived for other sample rates);
- 400 ms gating blocks with 75% overlap;
- absolute gate at -70 LKFS, then relative gate at (ungated mean - 10);
- loudness = -0.691 + 10 log10(sum_i G_i * z_i) over gated blocks.

Verified by the spec's anchor: a 997 Hz full-scale sine reads -3.01 LKFS.
"""

from __future__ import annotations

import numpy as np


def _k_weighting_coeffs(sr: float) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(b, a)] biquads: high-shelf then high-pass (pyloudnorm parametrization)."""
    # Stage 1: spectral shaping high-shelf.
    f0, g_db, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = np.tan(np.pi * f0 / sr)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh**0.499666774155
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array(
        [(vh + vb * k / q + k * k) / a0, 2.0 * (k * k - vh) / a0, (vh - vb * k / q + k * k) / a0]
    )
    a_shelf = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])

    # Stage 2: high-pass.
    f0, q = 38.13547087613982, 0.5003270373253953
    k = np.tan(np.pi * f0 / sr)
    denom = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0])
    a_hp = np.array([1.0, 2.0 * (k * k - 1.0) / denom, (1.0 - k / q + k * k) / denom])

    return [(b_shelf, a_shelf), (b_hp, a_hp)]


def _biquad(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Direct-form II transposed biquad (scipy.signal.lfilter equivalent)."""
    y = np.empty_like(x, dtype=np.float64)
    z1 = z2 = 0.0
    for i in range(x.shape[0]):
        xi = x[i]
        yi = b[0] * xi + z1
        z1 = b[1] * xi - a[1] * yi + z2
        z2 = b[2] * xi - a[2] * yi
        y[i] = yi
    return y


def _biquad_fast(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    try:
        from scipy.signal import lfilter

        return lfilter(b, a, x)
    except Exception:
        return _biquad(x, b, a)


def integrated_loudness(audio: np.ndarray, sr: int) -> float:
    """Integrated loudness (LKFS/LUFS) of mono or (n, channels) audio."""
    x = np.asarray(audio, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape

    block = int(0.4 * sr)
    hop = int(0.1 * sr)
    if n < block:
        # Degenerate input: pad like audiotools does for sub-block signals.
        x = np.concatenate([x, np.zeros((block - n, channels))], axis=0)
        n = block

    # K-weighting per channel.
    xw = np.empty_like(x)
    coeffs = _k_weighting_coeffs(sr)
    for c in range(channels):
        y = x[:, c]
        for b, a in coeffs:
            y = _biquad_fast(y, b, a)
        xw[:, c] = y

    # Gating-block mean squares.
    num_blocks = (n - block) // hop + 1
    starts = np.arange(num_blocks) * hop
    z = np.empty((num_blocks, channels))
    sq = xw * xw
    csum = np.concatenate([np.zeros((1, channels)), np.cumsum(sq, axis=0)])
    for i, s in enumerate(starts):
        z[i] = (csum[s + block] - csum[s]) / block

    # Channel weights: 1.0 for L/R/C, 1.41 for surrounds (mono/stereo -> 1.0).
    g = np.ones(channels)
    if channels >= 4:
        g[3:] = 1.41

    block_loudness = -0.691 + 10.0 * np.log10(np.maximum((z * g).sum(axis=1), 1e-30))

    # Absolute gate.
    mask = block_loudness > -70.0
    if not mask.any():
        return -np.inf
    ungated = (z[mask] * g).sum(axis=1).mean()
    gamma_r = -0.691 + 10.0 * np.log10(max(ungated, 1e-30)) - 10.0

    mask &= block_loudness > gamma_r
    if not mask.any():
        return -np.inf
    gated = (z[mask] * g).sum(axis=1).mean()
    return float(-0.691 + 10.0 * np.log10(max(gated, 1e-30)))


def normalize_loudness(audio: np.ndarray, sr: int, target_db: float) -> np.ndarray:
    """Gain the signal to the target integrated loudness (audiotools
    AudioSignal.normalize semantics)."""
    loudness = integrated_loudness(audio, sr)
    if not np.isfinite(loudness):
        return np.asarray(audio, np.float32)
    gain = 10.0 ** ((target_db - loudness) / 20.0)
    return (np.asarray(audio, np.float64) * gain).astype(np.float32)
