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

The kernel has three bodies, and the layout the wrapper builds once per base
tensor and caches (``kernel_layout``) says which one serves the bases:

- ``fft``: the bases are a windowed real DFT of a power-of-two size that the
  body takes (``bases_fft``; n_fft 512 or 1024: CLAP, and VGGish's
  400-sample window in a 512-point DFT). The frame is windowed, packed as
  n_fft/2 complex points, put through a radix-8 Stockham FFT and split into
  bins 0..n_fft/2, and only the bins of the mel bands are squared
  (``fused_log_mel_fft_reference`` is that formulation in plain torch);
- ``folded``: other bases of a periodic window with W = n_fft (Whisper,
  n_fft = 400), where ``dre[W - n] = dre[n]`` and ``dim[W - n] = -dim[n]``:
  the even/odd fold of each frame times rows 0..W/2 only, half the DFT
  arithmetic (``fused_log_mel_folded_reference``);
- ``unfolded``: any other bases, all W rows.

The FFT takes precedence over the fold. Every layout holds each mel column's
band of nonzero rows, the only rows the mel product visits.

Routing is by the tensor's device, and only by it:

- CPU tensors go to ``fused_log_mel_reference``, the plain torch twin;
- CUDA tensors launch the kernel (float32, M <= 128, 1 <= B <= 65535,
  N >= 1), or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

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
            fn = lib.fadtk_fused_log_mel_fft
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # frames, strides
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, N, W, n_fft
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # window, twiddle, bins
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # mel bands, M
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


def bases_fft(dft_re: torch.Tensor, dft_im: torch.Tensor) -> bool:
    """Are the (W, F) bases a windowed real DFT of a power-of-two size: n_fft =
    2 (F - 1) a power of two, W <= n_fft, and, with the window w = ``dft_re[:,
    0]``, ``dft_re[n, k] = w[n] cos(2 pi n k / n_fft)`` and ``dft_im[n, k] =
    -w[n] sin(2 pi n k / n_fft)`` to a few float32 ulps of the largest value
    (as ``bases_fold`` judges)?"""
    w, f = dft_re.shape
    n_fft = 2 * (f - 1)
    if f < 3 or n_fft & (n_fft - 1) or w > n_fft:
        return False
    dev = dft_re.device
    phase = (torch.arange(w, device=dev)[:, None] * torch.arange(f, device=dev)) % n_fft
    phase = phase.to(torch.float64) * (2.0 * math.pi / n_fft)
    window = dft_re[:, :1].to(torch.float64)
    tol = _FOLD_ULPS * torch.finfo(torch.float32).eps * float(
        max(dft_re.abs().max(), dft_im.abs().max()))
    return bool((dft_re - window * torch.cos(phase)).abs().max() <= tol
                and (dft_im + window * torch.sin(phase)).abs().max() <= tol)


class KernelLayout(NamedTuple):
    """What the kernel reads besides the frames, built once per base tensor.
    The FMA bodies read ``k``, ``bases`` and the mel matrix, the FFT body
    ``window``, ``twiddle``, ``bins`` and the packed mel bands; the other
    fields are None there."""

    body: str  # "fft" | "folded" | "unfolded"
    band: torch.Tensor  # (2, M) int32: first and one past the last nonzero row per mel column
    k: int | None = None  # product depth: W/2 + 1 folded, W unfolded
    bases: torch.Tensor | None = None  # (2, Kp, Fp) float32: re and im rows 0..k-1, zero-padded
    window: torch.Tensor | None = None  # (n_fft,) float32: dft_re[:, 0], zero-padded
    twiddle: torch.Tensor | None = None  # (n_fft, 2) float32: exp(-2 pi i j / n_fft)
    bins: tuple[int, int] | None = None  # [lo, hi): the union of the mel bands
    mel_packed: torch.Tensor | None = None  # float32: column m's band rows at packed_at[m]
    packed_at: torch.Tensor | None = None  # (M,) int32

    @property
    def fold(self) -> bool:
        return self.body == "folded"


_KP, _FP = 16, 128  # the FMA bodies' slice depth and chunk width
_FOLD_ULPS = 4
FFT_SIZES = (512, 1024)  # the n_fft the FFT body takes


def _bands(mel: torch.Tensor) -> torch.Tensor:
    f = mel.shape[0]
    rows = torch.arange(f, device=mel.device)[:, None]
    nz = mel != 0
    lo = torch.where(nz, rows, f).amin(dim=0)
    hi = torch.where(nz, rows + 1, 0).amax(dim=0)
    return torch.stack([lo, torch.maximum(hi, lo)]).to(torch.int32).contiguous()


def _fma_layout(dft_re, dft_im, mel) -> KernelLayout:
    """The folded or unfolded FMA body's layout of any (W, F) bases."""
    w, f = dft_re.shape
    fold = bases_fold(dft_re, dft_im)
    k = w // 2 + 1 if fold else w
    kp, fp = -(-k // _KP) * _KP, -(-f // _FP) * _FP
    bases = torch.zeros((2, kp, fp), dtype=torch.float32, device=dft_re.device)
    bases[0, :k, :f] = dft_re[:k]
    bases[1, :k, :f] = dft_im[:k]
    return KernelLayout("folded" if fold else "unfolded", _bands(mel), k=k, bases=bases)


def _fft_layout(dft_re, mel) -> KernelLayout:
    """The FFT body's layout of bases that ``bases_fft`` accepts."""
    w, f = dft_re.shape
    n_fft = 2 * (f - 1)
    window = torch.zeros(n_fft, dtype=torch.float32, device=dft_re.device)
    window[:w] = dft_re[:, 0]
    angle = torch.arange(n_fft, dtype=torch.float64, device=dft_re.device) * (-2.0 * math.pi
                                                                             / n_fft)
    twiddle = torch.stack([torch.cos(angle), torch.sin(angle)], dim=1).to(torch.float32)
    band = _bands(mel)
    live = band[0] < band[1]
    bins = ((int(band[0][live].min()), int(band[1][live].max())) if bool(live.any())
            else (0, 0))
    lo, hi = band.tolist()
    mel_packed = torch.cat([mel[a:b, m] for m, (a, b) in enumerate(zip(lo, hi))]).contiguous()
    lengths = band[1] - band[0]
    packed_at = (torch.cumsum(lengths, 0) - lengths).to(torch.int32)
    return KernelLayout("fft", band, window=window, twiddle=twiddle.contiguous(), bins=bins,
                        mel_packed=mel_packed, packed_at=packed_at)


def _build_layout(dft_re, dft_im, mel) -> KernelLayout:
    if 2 * (dft_re.shape[1] - 1) in FFT_SIZES and bases_fft(dft_re, dft_im):
        return _fft_layout(dft_re, mel)
    return _fma_layout(dft_re, dft_im, mel)


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


def fft_radices(p: int) -> list[int]:
    """The FFT body's radix steps for p = n_fft / 2 complex points: radix 8
    while 8 divides what is left, then one radix-4 or radix-2 step (512: 8 8 8;
    256: 8 8 4)."""
    radices = []
    while p > 1:
        radices.append(8 if p % 8 == 0 else p)
        p //= radices[-1]
    return radices


def _rot8(re, im, t: int):
    """(re, im) times exp(-2 pi i t / 8), t in 0..3, as the kernel's ``rot8``."""
    c = math.sqrt(0.5)
    if t == 1:
        return c * (re + im), c * (im - re)
    if t == 2:
        return im, -re
    if t == 3:
        return c * (im - re), -c * (re + im)
    return re, im


def _dft_small(v: list, r: int) -> list:
    """The r-point DFT (r in 2, 4, 8) of the (re, im) pairs ``v``, as the
    kernel's ``dft``: radix-2 decimation in frequency, then the bit reversal."""
    v = list(v)
    half = r // 2
    while half >= 1:
        for base in range(0, r, 2 * half):
            for i in range(half):
                (ar, ai), (br, bi) = v[base + i], v[base + i + half]
                v[base + i] = (ar + br, ai + bi)
                v[base + i + half] = _rot8(ar - br, ai - bi, i * 4 // half)
        half //= 2
    bits = r.bit_length() - 1
    return [v[int(f"{k:0{bits}b}"[::-1], 2)] for k in range(r)]


def _stockham_stage(re, im, r: int, ns: int, tw_re, tw_im):
    """One radix-r Stockham stage over the last dim (p points; ns points
    already combined): butterfly j takes points j + q p / r, twiddles point
    q by W_{ns r}^{q (j % ns)}, takes their r-point DFT and writes output q
    to (j // ns) ns r + j % ns + q ns. Natural order in and out."""
    p, n_fft = re.shape[-1], tw_re.shape[0]
    m = p // r
    j = torch.arange(m, device=re.device)
    v = [(re[..., q * m:(q + 1) * m], im[..., q * m:(q + 1) * m]) for q in range(r)]
    if ns > 1:
        for q in range(1, r):
            idx = q * (j % ns) * (n_fft // (ns * r))
            wr, wi = tw_re[idx], tw_im[idx]
            vr, vi = v[q]
            v[q] = (vr * wr - vi * wi, vr * wi + vi * wr)
    v = _dft_small(v, r)
    dst = (j // ns) * ns * r + j % ns
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    for q in range(r):
        out_re[..., dst + q * ns] = v[q][0]
        out_im[..., dst + q * ns] = v[q][1]
    return out_re, out_im


def fused_log_mel_fft_reference(
    frames: torch.Tensor,
    layout: KernelLayout,
    *,
    log_mode: str,
    log_offset: float = 0.0,
) -> torch.Tensor:
    """The FFT body's formulation in plain torch over an ``fft`` layout: the
    frame times the window, packed as z[n] = x[2n] + i x[2n+1] (n_fft / 2
    points), the radix steps of ``fft_radices`` with the layout's twiddles,
    the split X[k] = (Z[k] + conj Z[P-k]) / 2 + W^k (Z[k] - conj Z[P-k]) / 2i
    over the layout's bins, the power, the mel product with the layout's
    packed bands, the log. No ``torch.fft`` and no dense mel matrix: it
    checks the algorithm and the layout the kernel reads."""
    n_fft = layout.window.shape[0]
    p = n_fft // 2
    x = F.pad(frames * layout.window[: frames.shape[-1]], (0, n_fft - frames.shape[-1]))
    re, im = x[..., 0::2], x[..., 1::2]
    tw_re, tw_im = layout.twiddle[:, 0], layout.twiddle[:, 1]
    ns = 1
    for r in fft_radices(p):
        re, im = _stockham_stage(re, im, r, ns, tw_re, tw_im)
        ns *= r
    lo, hi = layout.bins
    k = torch.arange(lo, hi, device=frames.device)
    ar, ai = re[..., k % p], im[..., k % p]
    br, bi = re[..., (p - k) % p], im[..., (p - k) % p]
    er, ei = 0.5 * (ar + br), 0.5 * (ai - bi)
    o_r, oi = 0.5 * (ai + bi), 0.5 * (br - ar)
    wr, wi = tw_re[k], tw_im[k]
    xr = er + (wr * o_r - wi * oi)
    xi = ei + (wr * oi + wi * o_r)
    band, at = layout.band.long(), layout.packed_at.long()
    cols = torch.repeat_interleave(torch.arange(band.shape[1], device=band.device),
                                   band[1] - band[0])
    rows = band[0][cols] + torch.arange(cols.numel(), device=band.device) - at[cols] - lo
    mel = torch.zeros((hi - lo, band.shape[1]), dtype=torch.float32, device=frames.device)
    mel[rows, cols] = layout.mel_packed
    return _log((xr * xr + xi * xi) @ mel, log_mode, log_offset)


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
    lib = _library()
    if layout.body == "fft":
        rc = lib.fadtk_fused_log_mel_fft(
            frames.data_ptr(), fr3.stride(0), fr3.stride(1), b, n, w, layout.window.shape[0],
            layout.window.data_ptr(), layout.twiddle.data_ptr(), *layout.bins,
            layout.mel_packed.data_ptr(), layout.band.data_ptr(), layout.packed_at.data_ptr(), m,
            out.data_ptr(), LOG_MODES[log_mode], float(log_offset), stream,
        )
    else:
        _, kp, fp = layout.bases.shape
        rc = lib.fadtk_fused_log_mel(
            frames.data_ptr(), fr3.stride(0), fr3.stride(1), b, n, w, int(layout.fold),
            layout.bases.data_ptr(), kp, fp, f, mel.data_ptr(), layout.band.data_ptr(), m,
            out.data_ptr(), LOG_MODES[log_mode], float(log_offset), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_log_mel: {layout.body} body launch failed, cudaError {rc}")
    if layout.body == "fft":
        fused_log_mel.fft_launches += 1
    else:
        fused_log_mel.launches += 1
    return out if batched else out[0]


# Kernel launches since the last reset, by body: the folded and unfolded FMA
# bodies, and the FFT body (``chip_smoke.py`` zeroes them and reads them
# around the main path to show the path went through the kernel).
fused_log_mel.launches = 0
fused_log_mel.fft_launches = 0
