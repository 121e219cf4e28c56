"""Fused log-mel spectrogram (K3): the hand-written Hopper kernel and its plain twin.

``fused_log_mel`` is the port of ``fadtk_tpu/dsp/pallas_mel.py::fused_log_mel``:

    frames (N, W) -> re, im = frames @ dft_re, frames @ dft_im   (W, F)
                  -> power = re² + im² -> power @ mel (F, M) -> log

with the log in one of three modes: ``ln_offset`` (``log(x + log_offset)``),
``log10_clamp`` (Whisper, ``log10(max(x, 1e-10))``) and ``db_clamp``
(torchlibrosa / CLAP, ``10·log10(max(x, 1e-10))``). Everything is float32.

Frames come in as (N, W) or (B, N, W) with a unit sample stride and any
frame and batch strides, so a strided ``unfold`` view of a padded signal
(frame stride = hop) goes in as it is: the Pallas contract, a contiguous
(N, W) tensor, is the special case. The output is contiguous, (N, M) or
(B, N, M). The kernel is CUDA C++ for sm_90a
(``fadtk_tpu_torch/csrc/fused_log_mel.cu``; its header says what bounds it
and how it is laid out), built at first use (``ops/build.py``) and loaded
with ctypes.

The kernel reads the bases in a layout the wrapper builds once per base
tensor and caches (``kernel_layout``): where the bases are those of a
periodic window with W = n_fft (Whisper, CLAP), ``dre[W - n] = dre[n]`` and
``dim[W - n] = -dim[n]``, and the kernel multiplies the even/odd fold of each
frame by rows 0..W/2 only, half the DFT arithmetic
(``fused_log_mel_folded_reference`` is that formulation in plain torch);
other bases (VGGish: a 400-sample window in a 512-point DFT) keep all W rows.
The layout also holds each mel column's band of nonzero rows, the only rows
the kernel's mel product visits.

Routing is by the tensor's device, and only by it:

- CPU tensors go to ``fused_log_mel_reference``, the plain torch twin;
- CUDA tensors launch the kernel (float32, M <= 128, 1 <= B <= 65535,
  N >= 1), or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from . import build
from .layout_cache import LayoutCache

_SOURCE = build.CSRC / "fused_log_mel.cu"
LOG_MODES = {"ln_offset": 0, "log10_clamp": 1, "db_clamp": 2}
MAX_MELS = 128
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path() -> Path:
    """Build (if needed) the kernel library and return its path."""
    return build.library_path(_SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.fadtk_fused_log_mel
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # frames, strides
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, W, fold
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bases, Kp, Fp, F
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # mel, band, M
                ctypes.c_void_p, ctypes.c_int, ctypes.c_float,  # out, mode, log_offset
                ctypes.c_void_p,  # stream
            ]
            _LIB = lib
        return _LIB


def _log(mel_spec: torch.Tensor, log_mode: str, log_offset: float) -> torch.Tensor:
    if log_mode == "ln_offset":
        return torch.log(mel_spec + log_offset)
    if log_mode == "log10_clamp":
        return torch.log10(torch.clamp_min(mel_spec, 1e-10))
    if log_mode == "db_clamp":
        return 10.0 * torch.log10(torch.clamp_min(mel_spec, 1e-10))
    raise ValueError(f"fused_log_mel: log_mode {log_mode!r} not in {tuple(LOG_MODES)}")


def fused_log_mel_reference(
    frames: torch.Tensor,
    dft_re: torch.Tensor,
    dft_im: torch.Tensor,
    mel: torch.Tensor,
    *,
    log_mode: str,
    log_offset: float = 0.0,
) -> torch.Tensor:
    """Plain torch twin: the two DFT products, the power, the mel product
    and the log, each a separate op (the (..., F) power spectrum is
    materialised)."""
    re = frames @ dft_re
    im = frames @ dft_im
    return _log((re * re + im * im) @ mel, log_mode, log_offset)


def bases_fold(dft_re: torch.Tensor, dft_im: torch.Tensor) -> bool:
    """Do the (W, F) bases fold: W even, ``dre[W - n] = dre[n]`` and
    ``dim[W - n] = -dim[n]`` for 0 < n < W/2, to float32 accuracy (the bases
    are float64 values cast to float32, so the halves agree to about one ulp
    of the largest value, not bit for bit)?"""
    w = dft_re.shape[0]
    if w % 2 or w < 4:
        return False
    h = w // 2
    tol = _FOLD_ULPS * torch.finfo(torch.float32).eps * float(
        max(dft_re.abs().max(), dft_im.abs().max()))
    mirror = torch.arange(w - 1, h, -1, device=dft_re.device)  # W - n for n = 1 .. h - 1
    return bool((dft_re[1:h] - dft_re[mirror]).abs().max() <= tol
                and (dft_im[1:h] + dft_im[mirror]).abs().max() <= tol)


class KernelLayout(NamedTuple):
    """What the kernel reads besides the frames, built once per base tensor."""

    fold: bool
    k: int  # product depth: W/2 + 1 folded, W otherwise
    bases: torch.Tensor  # (2, Kp, Fp) float32: re and im rows 0..k-1, zero-padded
    band: torch.Tensor  # (2, M) int32: first and one past the last nonzero row per mel column


_KP, _FP = 16, 128  # the kernel's slice depth and chunk width
_FOLD_ULPS = 4


def _build_layout(dft_re, dft_im, mel) -> KernelLayout:
    w, f = dft_re.shape
    fold = bases_fold(dft_re, dft_im)
    k = w // 2 + 1 if fold else w
    kp, fp = -(-k // _KP) * _KP, -(-f // _FP) * _FP
    bases = torch.zeros((2, kp, fp), dtype=torch.float32, device=dft_re.device)
    bases[0, :k, :f] = dft_re[:k]
    bases[1, :k, :f] = dft_im[:k]
    rows = torch.arange(f, device=mel.device)[:, None]
    nz = mel != 0
    lo = torch.where(nz, rows, f).amin(dim=0)
    hi = torch.where(nz, rows + 1, 0).amax(dim=0)
    band = torch.stack([lo, torch.maximum(hi, lo)]).to(torch.int32).contiguous()
    return KernelLayout(fold, k, bases, band)


# The kernel's layout of a set of bases, built once per base tensor (while it
# lives; again if any of the three has other memory or was written in place).
kernel_layout = LayoutCache(_build_layout)


def fused_log_mel_folded_reference(
    frames: torch.Tensor,
    layout: KernelLayout,
    mel: torch.Tensor,
    *,
    log_mode: str,
    log_offset: float = 0.0,
) -> torch.Tensor:
    """The kernel's formulation in plain torch: the frames folded as the
    layout says (a = x[n] + x[W-n], b = x[n] - x[W-n] for 0 < n < W/2), the
    two products over the layout's rows, the power, the mel product, the log."""
    k, f = layout.k, mel.shape[0]
    re_rows, im_rows = layout.bases[0, :k, :f], layout.bases[1, :k, :f]
    if layout.fold:
        w = frames.shape[-1]
        h = w // 2
        lo = frames[..., : h + 1]
        hi = torch.zeros_like(lo)
        hi[..., 1:h] = frames[..., h + 1 :].flip(-1)  # x[W - n] for n = 1 .. h - 1
        a, b = lo + hi, lo - hi
    else:
        a = b = frames
    re, im = a @ re_rows, b @ im_rows
    return _log((re * re + im * im) @ mel, log_mode, log_offset)


def fused_log_mel(
    frames: torch.Tensor,
    dft_re: torch.Tensor,
    dft_im: torch.Tensor,
    mel: torch.Tensor,
    *,
    log_mode: str,
    log_offset: float = 0.0,
) -> torch.Tensor:
    """(N, W) or (B, N, W) frames -> (N, M) or (B, N, M) log-mel, float32.

    dft_re/dft_im: (W, F) window-folded DFT bases; mel: (F, M).
    CPU tensors run the plain twin; CUDA tensors launch the kernel or raise.
    """
    if log_mode not in LOG_MODES:
        raise ValueError(f"fused_log_mel: log_mode {log_mode!r} not in {tuple(LOG_MODES)}")
    if frames.device.type == "cpu":
        return fused_log_mel_reference(frames, dft_re, dft_im, mel, log_mode=log_mode,
                                       log_offset=log_offset)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device {frames.device}")
    if frames.dim() not in (2, 3):
        raise ValueError(f"fused_log_mel: expected frames (N, W) or (B, N, W), got "
                         f"{tuple(frames.shape)}")
    batched = frames.dim() == 3
    fr3 = frames if batched else frames[None]
    b, n, w = fr3.shape
    if frames.dtype != torch.float32:
        raise ValueError(f"fused_log_mel: frames must be float32, got {frames.dtype}")
    if w > 1 and fr3.stride(2) != 1:
        raise ValueError("fused_log_mel: frames need a unit sample stride (last dim)")
    if dft_re.dim() != 2 or dft_re.shape[0] != w or mel.dim() != 2:
        raise ValueError(f"fused_log_mel: bases {tuple(dft_re.shape)} / {tuple(mel.shape)} "
                         f"do not fit W={w}")
    f, m = dft_re.shape[1], mel.shape[1]
    for name, t, shape in (("dft_re", dft_re, (w, f)), ("dft_im", dft_im, (w, f)),
                           ("mel", mel, (f, m))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != frames.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_log_mel: {name} must be contiguous float32 {shape} on "
                             f"{frames.device}, got {t.dtype} {tuple(t.shape)} {t.device}")
    if not 1 <= m <= MAX_MELS:
        raise ValueError(f"fused_log_mel: M={m}; the kernel takes 1 <= M <= {MAX_MELS}")

    layout = kernel_layout(dft_re, dft_im, mel)
    out = torch.empty((b, n, m), dtype=torch.float32, device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    _, kp, fp = layout.bases.shape
    rc = _library().fadtk_fused_log_mel(
        frames.data_ptr(), fr3.stride(0), fr3.stride(1), b, n, w, int(layout.fold),
        layout.bases.data_ptr(), kp, fp, f, mel.data_ptr(), layout.band.data_ptr(), m,
        out.data_ptr(), LOG_MODES[log_mode], float(log_offset), stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_log_mel: kernel launch failed, cudaError {rc}")
    fused_log_mel.launches += 1
    return out if batched else out[0]


# Kernel launches since the last reset (``chip_smoke.py`` zeroes it and reads it
# around the main path to show the path went through the kernel).
fused_log_mel.launches = 0
