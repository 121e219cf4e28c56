"""STFT / log-mel frontends in PyTorch.

Port of ``fadtk_tpu/dsp/mel.py``. The numpy bases are copies of the JAX
package's, bit for bit: each is computed in float64 and cast to float32 once.

- ``whisper_log_mel`` (HF WhisperFeatureExtractor semantics): reflect-pad 200
  samples on each side, take the 400-sample frames at hop 160 as a strided
  view (``unfold``; HF drops the last of the 3001 frames), and hand the view
  to the fused log-mel kernel (``ops/fused_log_mel.py``, K3) in
  ``log10_clamp`` mode: DFT, power, slaney mel and ``log10(max(., 1e-10))``
  in one pass, the frame tensor never materialised. On CPU tensors the same
  call runs K3's plain twin. The per-clip dynamic-range clamp and the
  transpose to (B, 80, 3000) stay in torch.
- ``vggish_log_mel_examples`` (TF-VGGish): VGGish projects the *magnitude*
  ``sqrt(re² + im²)`` onto its mel bank, not the power K3 takes, so its
  frontend stays plain torch: ``framed_basis_matmul`` (the JAX package's
  hop-decomposed framed GEMM), the magnitude, the mel GEMM and
  ``log(mel + 0.01)``.

Both run on the device of the audio they are given.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# TF-VGGish constants (vggish_params / mel_features in the torch.hub dep).
VGGISH_SR = 16000
_WINDOW = int(round(VGGISH_SR * 0.025))  # 400
_HOP = int(round(VGGISH_SR * 0.010))  # 160
_FFT = 512  # 2 ** ceil(log2(400))
_MEL_BINS = 64
_MEL_MIN_HZ = 125.0
_MEL_MAX_HZ = 7500.0
_LOG_OFFSET = 0.01
_EXAMPLE_FRAMES = 96  # 0.96 s at the 100 Hz feature rate, hop == length

_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0


def hertz_to_mel(f):
    """HTK mel scale, natural-log variant used by TF-VGGish."""
    return _MEL_HIGH_Q * np.log(1.0 + np.asarray(f, np.float64) / _MEL_BREAK_HZ)


def mel_filterbank(
    num_mel_bins: int,
    num_spectrogram_bins: int,
    sample_rate: float,
    lower_edge_hertz: float,
    upper_edge_hertz: float,
) -> np.ndarray:
    """TF ``spectrogram_to_mel_matrix``: triangular overlapping bands, linear in
    mel, first spectrogram bin (DC) zeroed. Shape (num_spectrogram_bins, mels)."""
    nyquist = sample_rate / 2.0
    spec_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    edges = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz), num_mel_bins + 2
    )
    w = np.empty((num_spectrogram_bins, num_mel_bins))
    for i in range(num_mel_bins):
        lower, center, upper = edges[i : i + 3]
        lower_slope = (spec_mel - lower) / (center - lower)
        upper_slope = (upper - spec_mel) / (upper - center)
        w[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    w[0, :] = 0.0
    return w


def periodic_hann(n: int) -> np.ndarray:
    """TF-VGGish uses the periodic (DFT-even) Hann, not numpy's symmetric one."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi / n * np.arange(n))


def _windowed_dft(window_len: int, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Periodic-Hann-windowed real/imag DFT bases (window_len, n_fft//2 + 1),
    float64 then float32 (rfft with zero-padding to n_fft)."""
    window = periodic_hann(window_len)
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(window_len)
    phase = -2.0 * np.pi * np.outer(n, k) / n_fft
    return ((np.cos(phase) * window[:, None]).astype(np.float32),
            (np.sin(phase) * window[:, None]).astype(np.float32))


@lru_cache(maxsize=8)
def _vggish_bases() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windowed DFT real/imag bases (W, F), mel matrix (F, M)) in float32."""
    dft_re, dft_im = _windowed_dft(_WINDOW, _FFT)
    mel = mel_filterbank(_MEL_BINS, _FFT // 2 + 1, VGGISH_SR, _MEL_MIN_HZ, _MEL_MAX_HZ)
    return dft_re, dft_im, mel.astype(np.float32)


@lru_cache(maxsize=16)
def _device_bases(name: str, device: torch.device, *args) -> tuple[torch.Tensor, ...]:
    """A family's float32 bases as tensors on ``device``, made once."""
    arrays = {"vggish": _vggish_bases, "whisper": _whisper_bases,
              "torchlibrosa": _torchlibrosa_bases}[name](*args)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def framed_basis_matmul(
    x: torch.Tensor, window: int, hop: int, basis: torch.Tensor
) -> torch.Tensor:
    """frames(x) @ basis without materializing the frame tensor.

    x: (B, T); basis: (window, F); returns (B, n_frames, F) with the standard
    VALID framing n_frames = 1 + (T - window) // hop. The window decomposes
    into q = window // hop full hop-blocks plus an r-sample tail, so the
    framed matmul is q (+1) dense GEMMs over shifted contiguous views of one
    (B, n_blocks, hop) reshape, summed in the JAX package's order.
    """
    b, t = x.shape
    window, hop = int(window), int(hop)
    nf = 1 + (t - window) // hop
    q, r = divmod(window, hop)
    n_blocks = nf + q - (0 if r else 1)
    # n_blocks*hop covers the last VALID frame's span but can be shorter than
    # t: pad or trim to exactly n_blocks*hop (the tail is unused either way).
    x = F.pad(x[:, : n_blocks * hop], (0, max(0, n_blocks * hop - t)))
    blocks = x.reshape(b, n_blocks, hop)
    out = blocks[:, 0:nf] @ basis[:hop]
    for j in range(1, q):
        out = out + blocks[:, j : j + nf] @ basis[j * hop : (j + 1) * hop]
    if r:
        out = out + blocks[:, q : q + nf, :r] @ basis[q * hop :]
    return out


def _vggish_log_mel(x: torch.Tensor) -> torch.Tensor:
    """(T,) waveform (already trimmed to whole frames) -> (N, 64) log-mel of
    the *magnitude* spectrum."""
    dft_re, dft_im, mel = _device_bases("vggish", x.device)
    y = framed_basis_matmul(x[None], _WINDOW, _HOP, torch.cat([dft_re, dft_im], dim=1))[0]
    f = dft_re.shape[1]
    re, im = y[..., :f], y[..., f:]
    mag = torch.sqrt(re * re + im * im)
    return torch.log(mag @ mel + _LOG_OFFSET)


def vggish_num_examples(num_samples: int) -> int:
    if num_samples < _WINDOW:
        return 0
    num_frames = 1 + (num_samples - _WINDOW) // _HOP
    return num_frames // _EXAMPLE_FRAMES


def vggish_log_mel_examples(audio: torch.Tensor) -> torch.Tensor:
    """(T,) float waveform at 16 kHz -> (n_examples, 96, 64) float32 log-mel
    examples, on the audio's device.

    Matches TF-VGGish ``waveform_to_examples`` (the partial tail example is
    dropped by the non-overlapping example framing).
    """
    n_examples = vggish_num_examples(audio.shape[0])
    if n_examples == 0:
        return torch.zeros((0, _EXAMPLE_FRAMES, _MEL_BINS), dtype=torch.float32,
                           device=audio.device)
    used = (n_examples * _EXAMPLE_FRAMES - 1) * _HOP + _WINDOW
    log_mel = _vggish_log_mel(audio[:used].to(torch.float32))
    return log_mel.reshape(n_examples, _EXAMPLE_FRAMES, _MEL_BINS)


# --------------------------------------------------------------------------- #
# Whisper frontend (HF WhisperFeatureExtractor semantics)
# --------------------------------------------------------------------------- #

WHISPER_SR = 16000
WHISPER_SAMPLES = 30 * WHISPER_SR  # fixed 30 s window (pad/truncate)
_W_FFT = 400
_W_HOP = 160
_W_MELS = 80


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    mels = 3.0 * f / 200.0
    log_region = f >= 1000.0
    return np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0, mels
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


def mel_filterbank_slaney(
    num_mel_bins: int, num_spectrogram_bins: int, sample_rate: float,
    min_hz: float, max_hz: float,
) -> np.ndarray:
    """librosa-style slaney-scale, slaney-normalized triangular filterbank
    (== transformers.audio_utils.mel_filter_bank(norm='slaney',
    mel_scale='slaney')). Shape (spec_bins, mels)."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, num_spectrogram_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(min_hz), _hz_to_mel_slaney(max_hz), num_mel_bins + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]  # (bins, mels + 2)
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return fb * enorm[None, :]


@lru_cache(maxsize=4)
def _whisper_bases() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    dft_re, dft_im = _windowed_dft(_W_FFT, _W_FFT)
    mel = mel_filterbank_slaney(_W_MELS, _W_FFT // 2 + 1, WHISPER_SR, 0.0, 8000.0)
    return dft_re, dft_im, mel.astype(np.float32)


def whisper_frames(audio: torch.Tensor) -> torch.Tensor:
    """(B, 480000) audio -> (B, 3000, 400) float32 frames as a strided view
    of the reflect-padded signal (batch stride 480400, frame stride 160,
    unit sample stride); HF drops the last of the 3001 frames."""
    x = F.pad(audio.to(torch.float32)[:, None], (_W_FFT // 2, _W_FFT // 2), mode="reflect")[:, 0]
    return x.unfold(-1, _W_FFT, _W_HOP)[:, :-1]


def whisper_log_mel(audio: torch.Tensor) -> torch.Tensor:
    """(B, 480000) 16 kHz audio -> (B, 80, 3000) normalized log-mel features.

    Matches HF WhisperFeatureExtractor: centered reflect-padded STFT (periodic
    Hann 400 / hop 160), power spectrum, slaney mel, log10 clamp at 1e-10
    (these four in K3, one launch per call on a CUDA tensor), per-clip
    dynamic-range clamp (max - 8), then (x + 4) / 4.
    """
    from ..ops.fused_log_mel import fused_log_mel

    dft_re, dft_im, mel = _device_bases("whisper", audio.device)
    log_spec = fused_log_mel(whisper_frames(audio), dft_re, dft_im, mel, log_mode="log10_clamp")
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(1, 2)  # (B, 80, frames)


# --------------------------------------------------------------------------- #
# torchlibrosa-style bases (CLAP frontends: laion_clap 48k, msclap 44.1k)
# --------------------------------------------------------------------------- #


@lru_cache(maxsize=8)
def _torchlibrosa_bases(n_fft: int, sr: int, n_mels: int, fmin: float, fmax: float):
    dft_re, dft_im = _windowed_dft(n_fft, n_fft)
    mel = mel_filterbank_slaney(n_mels, n_fft // 2 + 1, sr, fmin, fmax)
    return dft_re, dft_im, mel.astype(np.float32)
