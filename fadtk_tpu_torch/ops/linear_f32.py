"""The float32 projection ``x · Wᵀ (+ bias)`` as 3xTF32 on the tensor cores (K6): the
hand-written Hopper kernel and its plain twin.

Its kernel (``fadtk_tpu_torch/csrc/linear_f32.cu``; its header says what bounds
it and how it is laid out) is a port-only kernel: XLA does the JAX package's
dots. It splits each operand into two TF32 values and sums three tensor-core
products in float32, which keeps float32's accuracy (the card tests and
``chip_smoke.py`` hold it to within 2x of cuBLAS's float32 error against a
float64 product) at several times the rate of the CUDA cores' sgemm.

``linear_f32(x, weight, bias)`` is ``F.linear``: CPU tensors go to
``F.linear`` itself, the twin; CUDA tensors launch the kernel or raise, with
no fallback. ``takes(x, weight)`` says which projections the kernel should
serve (``models/base.py::linear`` routes by it): a float32 product on the
card with at least ``MIN_ROWS`` rows and ``MIN_COLUMNS`` output features, K
a multiple of 4 (TMA's 16-byte row stride).

The weight's TF32 remainder ``weight_lo(weight)`` is made once per weight and
kept while the weight lives (``layout_cache.LayoutCache``): a routed weight
costs its size again in device memory.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from . import build
from .layout_cache import LayoutCache

_SOURCE = build.CSRC / "linear_f32.cu"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

# Below these the product stays on cuBLAS. The kernel runs one 128 x 128
# output tile per SM through the whole of K, so a product of few tiles leaves
# most of the card idle. Against cuBLAS float32 (scripts/torch_linear_f32_probe.py,
# H100 SXM at 700 W): at K = N = 768 the kernel is 0.65x at 512 rows, 0.97x at
# 1024 and 2.00x at 2048; at K = 512, N = 768 1.11x at 1024; at K = N = 1280
# 1.03x at 512 and 1.66x at 1024; at N >= 4096 it wins from 256-512 rows.
# Output widths of 8-32 lose at every row count up to 47984 (0.51-0.86x at
# K = 768 and 1024), 64 wins only at 47984 rows (1.5x), 128 from 8192
# (1.28-1.42x). Depth gets no floor of its own: at 8192 rows K = 64-384
# reads 0.85-2.34x, at 47984 rows 1.95-2.50x; at 1024 rows it loses
# (0.22-0.89x), which only a tensor-parallel shard of a small batch meets
# (the models' own depths are 512 and more).
MIN_ROWS = 1024
MIN_COLUMNS = 128

_TF32_MASK = -8192  # 0xffffe000 as an int32: the sign, exponent and 10 mantissa bits


def library_path() -> Path:
    """Build (if needed) the kernel library and return its path."""
    return build.library_path(_SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.fadtk_linear_f32
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """``v`` with the 13 low mantissa bits cleared: the TF32 value the
    tensor cores read from a float32 operand."""
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32, to nearest with ties away from zero
    (``tf32_rna`` in ``csrc/tf32.cuh``), for finite ``v``."""
    return ((v.view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)


def weight_lo(weight: torch.Tensor) -> torch.Tensor:
    """The weight's TF32 remainder, ``tf32_round(weight - tf32_truncate(weight))``:
    the kernel reads ``weight`` as its high part, which the tensor cores
    truncate, and this beside it. Contiguous, in the weight's memory."""
    w = weight.detach().contiguous()
    return tf32_round(w - tf32_truncate(w))


_weight_lo = LayoutCache(weight_lo)


def takes(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether ``linear_f32`` should serve ``F.linear(x, weight)``: a float32
    product on the card with at least ``MIN_ROWS`` rows and ``MIN_COLUMNS``
    output features, K a multiple of 4, and a contiguous, 16-byte aligned
    weight."""
    n, k = weight.shape
    return (x.is_cuda and x.dtype == torch.float32 and weight.dtype == torch.float32
            and weight.is_contiguous() and weight.data_ptr() % 16 == 0
            and x.numel() // k >= MIN_ROWS and n >= MIN_COLUMNS and k % 4 == 0)


def _check(x, weight, bias) -> None:
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or weight.dim() != 2:
        raise ValueError("linear_f32: x and a 2-d weight must be float32, got "
                         f"{x.dtype} {tuple(x.shape)} and {weight.dtype} {tuple(weight.shape)}")
    n, k = weight.shape
    if x.shape[-1] != k or k % 4:
        raise ValueError(f"linear_f32: x {tuple(x.shape)} against weight {tuple(weight.shape)}: "
                         "the last dims must agree and be a multiple of 4")
    if not weight.is_contiguous() or weight.data_ptr() % 16:
        raise ValueError("linear_f32: the weight must be contiguous and 16-byte aligned")
    tensors = [("weight", weight)] + ([] if bias is None else [("bias", bias)])
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"linear_f32: {name} on {t.device}, x on {x.device}")
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"linear_f32: bias must be contiguous float32 ({n},), got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def linear_f32(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)``. CPU tensors run ``F.linear``; CUDA
    tensors launch the kernel or raise: float32 throughout, the weight (N, K)
    contiguous and 16-byte aligned with K a multiple of 4, the bias (N,)."""
    if x.device.type == "cpu":
        return F.linear(x, weight, bias)
    _check(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"linear_f32: unsupported device {x.device}")
    n, k = weight.shape
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    lo = _weight_lo(weight)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().fadtk_linear_f32(
        x2.data_ptr(), weight.data_ptr(), lo.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"linear_f32: kernel launch failed, error {rc}")
    linear_f32.launches += 1
    return y.reshape(*x.shape[:-1], n)


# Kernel launches since the last reset (the card tests and chip_smoke.py
# read it around a forward to show the path went through the kernel).
linear_f32.launches = 0
