"""Fused SEANet residual block (EnCodec 24 kHz): the hand-written Hopper kernel and its plain twin.

``fused_resnet_causal`` is the port of
``fadtk_tpu/ops/fused_resnet.py::fused_resnet_causal``, with its signature and
layouts: x (B, C, T), w1 (C/2, C, 3), b1 (C/2,), w2 (C, C/2), b2 (C,),
wsc (C, C), bsc (C,). It computes the 24 kHz encoder's residual block in one
pass over x:

    out = wsc·x + bsc + w2·elu(w1 ⊛ reflectpad₂(elu(x)) + b1) + b2

where ``w1 ⊛`` is the causal k=3 conv with ``elu(x)`` reflected by two
columns on the left. Products accumulate in float32; in bf16 each product is
rounded to the input dtype before its bias is added, as in the Pallas kernel.
The kernel is CUDA C++ for sm_90a (``fadtk_tpu_torch/csrc/fused_resnet_causal.cu``;
its header says what bounds it and how it is laid out), built at first use
(``ops/build.py``) and loaded with ctypes. Both forms run on the tensor
cores: float32 as 3xTF32 (each product taken three times on TF32 operands
split into hi and lo parts, ``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``, float32
accumulation), bf16 as ``mma.sync`` bf16 -> float32. Each form reads the
weights in its own layout, prepared once per weight set and cached
(``kernel_weights``): split into TF32 hi and lo parts and packed in the
``m16n8k8`` fragment order (float32), or packed in the ``m16n8k16``
fragment order (bf16).

Routing is by the tensor's device, and only by it:

- CPU tensors go to ``fused_resnet_causal_reference``, the plain torch twin;
- CUDA tensors launch the kernel (float32 or bf16, C in 32/64/128/256,
  T >= 3, contiguous x), or raise. There is no fallback.

The model takes this path only under ``FADTK_TPU_FUSED_RESNET`` (off by
default, as in the JAX package; ``models/encodec_impl.py::_resnet_block``).
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from . import build
from .layout_cache import LayoutCache

_SOURCE = build.CSRC / "fused_resnet_causal.cu"
WIDTHS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def fused_resnet_enabled() -> bool:
    """Route the 24 kHz residual blocks through the fused kernel?
    ``FADTK_TPU_FUSED_RESNET`` decides; default off, as in the JAX package."""
    env = os.environ.get("FADTK_TPU_FUSED_RESNET")
    if env is not None and env.strip():
        from ..models.precision import _TRUTHY

        return env.strip().lower() in _TRUTHY
    return False


def library_path() -> Path:
    """Build (if needed) the kernel library and return its path."""
    return build.library_path(_SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            for name in ("fadtk_fused_resnet_causal", "fadtk_fused_resnet_causal_bf16"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """(N, K) weights, as ``[out][in]``, in the order ``mma.sync.m16n8k16``
    takes its B operand: (N/8, K/16, 32 lanes, 4). Lane l of n8 tile i and
    k16 tile j holds ``w[8i + l//4, 16j + 2(l%4) + (0, 1, 8, 9)]``: one
    8-byte load per lane and fragment."""
    n, k = w.shape
    lane = torch.arange(32, device=w.device)
    cols = 2 * (lane % 4)[:, None] + torch.tensor([0, 1, 8, 9], device=w.device)  # (32, 4)
    tiles = w.reshape(n // 8, 8, k // 16, 16).permute(0, 2, 1, 3)  # (N/8, K/16, 8, 16)
    rows = tiles[:, :, lane // 4]  # (N/8, K/16, 32, 16): lane l's row of its tile
    return torch.gather(rows, 3, cols.expand(n // 8, k // 16, 32, 4)).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits of
    the result are zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``: their sum
    is ``x`` within 2^-22 relative, each exactly a TF32 value."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_tf32_fragments(w: torch.Tensor) -> torch.Tensor:
    """(N, K) float32 weights, as ``[out][in]``, split into TF32 hi and lo
    parts and laid out in the order ``mma.sync.m16n8k8`` (tf32) takes its B
    operand: (N/8, K/8, 32 lanes, 4). Lane l of n8 tile i and k8 tile j
    holds ``hi, lo`` of ``w[8i + l//4, 8j + l%4 + (0, 4)]`` as
    ``(hi0, hi4, lo0, lo4)``: one 16-byte load per lane and fragment."""
    n, k = w.shape
    lane = torch.arange(32, device=w.device)
    cols = (lane % 4)[:, None] + torch.tensor([0, 4], device=w.device)  # (32, 2)

    def pick(a):
        tiles = a.reshape(n // 8, 8, k // 8, 8).permute(0, 2, 1, 3)  # (N/8, K/8, 8, 8)
        return torch.gather(tiles[:, :, lane // 4], 3, cols.expand(n // 8, k // 8, 32, 2))

    hi, lo = split_tf32(w)
    return torch.cat([pick(hi), pick(lo)], dim=3).contiguous()


def _build_weights(w1, b1, w2, b2, wsc, bsc) -> tuple[torch.Tensor, ...]:
    biases = tuple(v.float().contiguous() for v in (b1, b2, bsc))
    ch, c, _ = w1.shape
    w1r = w1.permute(0, 2, 1).reshape(ch, 3 * c)  # K = (tap, channel)
    pack = pack_fragments if w1.dtype == torch.bfloat16 else pack_tf32_fragments
    packed = tuple(pack(w) for w in (w1r, w2, wsc))
    return packed[0], biases[0], packed[1], biases[1], packed[2], biases[2]


# The kernel's layout of one weight set, (w1, b1, w2, b2, wsc, bsc) as the
# entry point takes them, built once per weight set: weights do not change
# after load, so a forward's four calls cost four lookups.
kernel_weights = LayoutCache(_build_weights)


def fused_resnet_causal_reference(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    wsc: torch.Tensor,
    bsc: torch.Tensor,
) -> torch.Tensor:
    """Plain torch twin: ELU, reflect-pad 2 on the left, the k=3 conv, ELU,
    the k=1 conv, and the k=1 shortcut plus the sum. Each conv output is
    taken in the input dtype before its bias is added, where the kernel
    rounds."""
    e = F.pad(F.elu(x), (2, 0), mode="reflect")
    h = F.elu(F.conv1d(e, w1) + b1[:, None])
    z = F.conv1d(h, w2[:, :, None]) + b2[:, None]
    sc = F.conv1d(x, wsc[:, :, None]) + bsc[:, None]
    return sc + z


def fused_resnet_causal(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    wsc: torch.Tensor,
    bsc: torch.Tensor,
) -> torch.Tensor:
    """The causal-reflect SEANet residual block, (B, C, T) -> (B, C, T).

    CPU tensors run the plain twin; CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return fused_resnet_causal_reference(x, w1, b1, w2, b2, wsc, bsc)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_causal: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_resnet_causal: expected x (B, C, T), got {tuple(x.shape)}")
    b, c, t = x.shape
    ch = c // 2
    if c not in WIDTHS:
        raise ValueError(f"fused_resnet_causal: C={c}; the kernel takes C in {WIDTHS}")
    if x.dtype not in DTYPES:
        raise ValueError(f"fused_resnet_causal: dtype {x.dtype} (bf16 or float32 only)")
    if t < 3:
        raise ValueError(f"fused_resnet_causal: T={t}; the reflect pad needs T >= 3")
    if not x.is_contiguous():
        raise ValueError("fused_resnet_causal: x must be contiguous")
    for name, w, shape in (("w1", w1, (ch, c, 3)), ("b1", b1, (ch,)), ("w2", w2, (c, ch)),
                           ("b2", b2, (c,)), ("wsc", wsc, (c, c)), ("bsc", bsc, (c,))):
        if tuple(w.shape) != shape or w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"fused_resnet_causal: {name} must be {x.dtype} {shape} on "
                             f"{x.device}, got {w.dtype} {tuple(w.shape)} {w.device}")

    layout = kernel_weights(w1, b1, w2, b2, wsc, bsc)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _library()
    fn = lib.fadtk_fused_resnet_causal_bf16 if x.dtype == torch.bfloat16 else \
        lib.fadtk_fused_resnet_causal
    rc = fn(x.data_ptr(), *(w.data_ptr() for w in layout), out.data_ptr(), b, c, t, stream)
    if rc != 0:
        raise RuntimeError(f"fused_resnet_causal: kernel launch failed, cudaError {rc}")
    if x.dtype == torch.bfloat16:
        fused_resnet_causal.bf16_launches += 1
    else:
        fused_resnet_causal.launches += 1
    return out


# Kernel launches since the last reset, of the float32 (3xTF32) kernel and of
# the bf16 one (``chip_smoke.py`` zeroes them and reads them around the main
# path to show the path went through the kernel).
fused_resnet_causal.launches = 0
fused_resnet_causal.bf16_launches = 0
