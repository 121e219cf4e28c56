"""Packed-heads flash attention: the hand-written Hopper kernel and its plain twin.

``flash_attention_packed`` is the port of
``fadtk_tpu/ops/flash_attention.py::flash_attention_packed``: non-causal
attention over q, k, v in the (B, T, H*D) layout the projection GEMMs write,
with a per-batch prefix key mask ``n_valid`` (clamped to [1, T]), float32
logits / softmax state / accumulator, and the output in the input dtype.
WavLM's factorized gated relative-position bias comes as two optional
float32 operands, ``position_bias`` (H, T, T) and ``gate`` (B, T, H):
``s = q·k/√d + gate[b, t, h] · position_bias[h, t, s]`` before the key mask,
without ever building the dense (B, H, T, T) bias. The kernel is CUDA C++ for
sm_90a
(``fadtk_tpu_torch/csrc/flash_attention_packed.cu``; its header says what
bounds it and how it is laid out).

Routing is by the tensor's device, and only by it:

- CPU tensors go to ``flash_attention_packed_reference``, the plain torch twin
  (same signature, keys masked at ``n_valid``, every row finite);
- CUDA tensors launch the kernel, or raise. There is no fallback.

The kernel is built at first use from the source in the repository into a
shared library with a plain C entry point (``ops/build.py``), loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import torch

from . import build

HEAD_DIM = 64
_NEG = -0.7 * torch.finfo(torch.float32).max  # finite "-inf" (NaN-safe)

_SOURCE = build.CSRC / "flash_attention_packed.cu"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_enabled(device: torch.device) -> bool:
    """Use the fused kernel? ``FADTK_TPU_FLASH_ATTENTION`` decides when set;
    by default it is on for CUDA tensors and off on the CPU, where the
    encoder keeps its plain attention (the twin still serves a forced-on
    call there)."""
    env = os.environ.get("FADTK_TPU_FLASH_ATTENTION")
    if env is not None and env.strip():
        from ..models.precision import _TRUTHY

        return env.strip().lower() in _TRUTHY
    return device.type == "cuda"


def library_path() -> Path:
    """Build (if needed) the kernel library and return its path."""
    return build.library_path(_SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.fadtk_flash_attention_packed
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def flash_attention_packed_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: torch.Tensor | None = None,
    position_bias: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
    *,
    num_heads: int,
) -> torch.Tensor:
    """Plain torch twin of the kernel: same signature and contract.

    With ``position_bias`` (H, T, T) and ``gate`` (B, T, H), both float32,
    ``gate[b, t, h] · position_bias[h, t, s]`` is added to the scaled logits
    in float32. Keys ``>= n_valid[b]`` (clamped to [1, T]) are then masked
    with the kernel's finite ``_NEG``; logits and softmax are float32. As in
    the kernel (and the Pallas kernel), the unnormalised ``p = exp(s - max)``
    is cast to the input dtype before the p·v product, and the float32 sum
    of p divides afterwards: rounding the normalised weights instead would
    put a 2^-9 relative error on the largest weight of a peaked row. Rows
    ``>= n_valid`` attend over the valid prefix, so every row is finite (the
    kernel zeroes whole 64-row tiles beyond ``n_valid`` instead; callers mask
    padded rows either way).
    """
    if (position_bias is None) != (gate is None):
        raise ValueError("position_bias and gate come together")
    b, t, hd = q.shape
    d = hd // num_heads
    if n_valid is None:
        nv = torch.full((b,), t, dtype=torch.int64, device=q.device)
    else:
        nv = n_valid.to(device=q.device, dtype=torch.int64).clamp(1, t)
    key_live = torch.arange(t, device=q.device)[None, :] < nv[:, None]  # (B, T)

    def heads(x):
        return x.reshape(b, t, num_heads, d).transpose(1, 2).float()

    logits = heads(q) @ heads(k).transpose(-1, -2) * (d ** -0.5)
    if position_bias is not None:
        logits = logits + gate.float().transpose(1, 2)[..., None] * position_bias.float()[None]
    logits = logits.masked_fill(~key_live[:, None, None, :], _NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (p.to(v.dtype).float() @ heads(v)) / p.sum(dim=-1, keepdim=True)  # (B, H, T, D)
    return out.to(q.dtype).transpose(1, 2).reshape(b, t, hd)


def flash_attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: torch.Tensor | None = None,
    position_bias: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
    *,
    num_heads: int,
) -> torch.Tensor:
    """softmax(q kᵀ/√d [+ gate·position_bias]) v per head over
    (B, T, H*D)-packed q/k/v, returning (B, T, H*D) ready for out_proj.
    ``n_valid``: (B,) valid key counts; ``position_bias`` (H, T, T) and
    ``gate`` (B, T, H): float32, given together or not at all.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (bf16 or
    float32, head dim 64, contiguous, 16-byte aligned) or raise.
    """
    if (position_bias is None) != (gate is None):
        raise ValueError("flash_attention_packed: position_bias and gate come together")
    if q.device.type == "cpu":
        return flash_attention_packed_reference(
            q, k, v, n_valid, position_bias, gate, num_heads=num_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"expected (B, T, H*D) tensors, got {tuple(q.shape)}")
    b, t, hd = q.shape
    if hd != num_heads * HEAD_DIM:
        raise ValueError(
            f"flash_attention_packed: head dim {hd // max(num_heads, 1)} "
            f"(H*D={hd}, H={num_heads}); the kernel takes D={HEAD_DIM} only"
        )
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_packed: dtype {q.dtype} (bf16 or float32 only)")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_packed: {name} does not match q "
                             f"({tuple(x.shape)} {x.dtype} {x.device})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_attention_packed: {name} must be contiguous and 16-byte aligned")
    if n_valid is None:
        nv = torch.full((b,), t, dtype=torch.int32, device=q.device)
    else:
        if n_valid.shape != (b,):
            raise ValueError(f"n_valid must have shape ({b},), got {tuple(n_valid.shape)}")
        nv = n_valid.to(device=q.device, dtype=torch.int32).contiguous()
    bias_ptrs = (None, None)
    if position_bias is not None:
        for name, x, shape in (("position_bias", position_bias, (num_heads, t, t)),
                               ("gate", gate, (b, t, num_heads))):
            if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != q.device:
                raise ValueError(f"flash_attention_packed: {name} must be float32 {shape} on "
                                 f"{q.device}, got {x.dtype} {tuple(x.shape)} {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"flash_attention_packed: {name} must be contiguous")
        bias_ptrs = (position_bias.data_ptr(), gate.data_ptr())

    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().fadtk_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nv.data_ptr(), *bias_ptrs, out.data_ptr(),
        b, t, num_heads, _DTYPE_CODE[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed: kernel launch failed, cudaError {rc}")
    if position_bias is None:
        flash_attention_packed.launches += 1
    else:
        flash_attention_packed.bias_launches += 1
    return out


# Kernel launches since the last reset, by form: ``launches`` counts the
# no-bias kernel, ``bias_launches`` the factorized-bias one (``chip_smoke.py``
# zeroes both and reads them around the main path to show the path went
# through the kernels).
flash_attention_packed.launches = 0
flash_attention_packed.bias_launches = 0
