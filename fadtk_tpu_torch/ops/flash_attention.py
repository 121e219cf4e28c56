"""Flash attention for the speech encoders: the hand-written Hopper kernel and
its plain twins, in the JAX package's two layouts.

``flash_attention_packed`` (K1, and K1b with the bias) is the port of
``fadtk_tpu/ops/flash_attention.py::flash_attention_packed``: non-causal
attention over q, k, v in the (B, T, H*D) layout the projection GEMMs write,
with a per-batch prefix key mask ``n_valid`` (clamped to [1, T]), float32
logits / softmax state / accumulator, and the output in the input dtype.
WavLM's factorized gated relative-position bias comes as two optional
float32 operands, ``position_bias`` (H, T, T) and ``gate`` (B, T, H):
``s = q·k/√d + gate[b, t, h] · position_bias[h, t, s]`` before the key mask,
without ever building the dense (B, H, T, T) bias.

``flash_attention`` (K2) is the port of
``fadtk_tpu/ops/flash_attention.py::flash_attention``: the same function on
head-major (B, H, T, D) tensors, with the gate (B, H, T), and the grouped
form (``_kernel_grouped``, G heads per program) behind
``FADTK_TPU_FLASH_GROUPED=1``. It takes any (batch, head, row) strides with a
unit last dim, so the tensor-parallel path's head-split views of a packed
projection go in without a copy.

Both are one CUDA C++ source for sm_90a
(``fadtk_tpu_torch/csrc/flash_attention_packed.cu``; its header says what
bounds it and how the layouts are read). Routing is by the tensor's device,
and only by it:

- CPU tensors go to the plain torch twins, ``flash_attention_packed_reference``
  and ``flash_attention_reference`` (same signatures, keys masked at
  ``n_valid``, every row finite);
- CUDA tensors launch the kernel, or raise. There is no fallback.

The kernel is built at first use from the source in the repository into a
shared library with plain C entry points (``ops/build.py``), loaded with
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
            fn = lib.fadtk_flash_attention_headmajor
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn = lib.fadtk_flash_attention_pick_group
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int] * 4
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

    def heads(x):
        return x.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)

    out = flash_attention_reference(  # (B, H, T, D)
        heads(q), heads(k), heads(v), n_valid, position_bias,
        None if gate is None else gate.transpose(1, 2),
    )
    return out.transpose(1, 2).reshape(b, t, hd)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: torch.Tensor | None = None,
    position_bias: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain torch twin of the head-major kernel (K2): the contract of
    ``flash_attention`` (whose ``grouped`` changes only how the kernel is
    launched), and the arithmetic of ``flash_attention_packed_reference``,
    which is this function on the head-split views.

    q, k, v (B, H, T, D) of any strides; ``gate`` (B, H, T).
    """
    if (position_bias is None) != (gate is None):
        raise ValueError("position_bias and gate come together")
    b, _, t, d = q.shape
    if n_valid is None:
        nv = torch.full((b,), t, dtype=torch.int64, device=q.device)
    else:
        nv = n_valid.to(device=q.device, dtype=torch.int64).clamp(1, t)
    key_live = torch.arange(t, device=q.device)[None, :] < nv[:, None]  # (B, T)

    logits = q.float() @ k.float().transpose(-1, -2) * (d ** -0.5)
    if position_bias is not None:
        logits = logits + gate.float()[..., None] * position_bias.float()[None]
    logits = logits.masked_fill(~key_live[:, None, None, :], _NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (p.to(v.dtype).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


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


def _row_aligned(x: torch.Tensor) -> bool:
    """16-byte base pointer and (batch, head, row) strides, unit last dim:
    the kernel loads each row 16 bytes a thread. Strides of size-1 dims are
    never used."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(x.stride(i) * x.element_size() % 16 == 0
                    for i in range(3) if x.shape[i] > 1))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_valid: torch.Tensor | None = None,
    position_bias: torch.Tensor | None = None,
    gate: torch.Tensor | None = None,
    *,
    grouped: bool | None = None,
) -> torch.Tensor:
    """softmax(q kᵀ/√d [+ gate ⊙ position_bias]) v per (batch, head), K2.

    q, k, v: (B, H, T, D), any (batch, head, row) strides with a unit last
    dim; ``n_valid``: (B,) valid key counts (clamped to >= 1; None = all T);
    ``position_bias`` (H, T, T) and ``gate`` (B, H, T): float32, given
    together or not at all. Returns (B, H, T, D) in q's dtype, laid out like
    q when q is dense (so a head-split view of a packed projection gives a
    head-split view of a packed output, and the caller's merge back to
    (B, T, H*D) is free). Rows t >= n_valid[b] are padding: finite, exact
    zeros in fully padded 64-row tiles.

    ``grouped`` (None: ``FADTK_TPU_FLASH_GROUPED=1`` decides, as in the JAX
    package) runs G heads per CTA, G picked for the card
    (``fadtk_flash_attention_pick_group``); without bias only, and the
    per-head grid when no G > 1 fills the card.

    CPU tensors run the plain twin; CUDA tensors launch the kernel (bf16 or
    float32, head dim 64, 16-byte aligned rows) or raise.
    """
    if (position_bias is None) != (gate is None):
        raise ValueError("flash_attention: position_bias and gate come together")
    if grouped is None:
        grouped = os.environ.get("FADTK_TPU_FLASH_GROUPED", "").strip() == "1"
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, n_valid, position_bias, gate)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention: expected (B, H, T, D) tensors, got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d}; the kernel takes D={HEAD_DIM} only")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} (bf16 or float32 only)")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention: {name} does not match q "
                             f"({tuple(x.shape)} {x.dtype} {x.device})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _row_aligned(x):
            raise ValueError(f"flash_attention: {name} needs a unit last stride and 16-byte "
                             f"aligned rows, got strides {x.stride()}")
    if n_valid is None:
        nv = torch.full((b,), t, dtype=torch.int32, device=q.device)
    else:
        if n_valid.shape != (b,):
            raise ValueError(f"n_valid must have shape ({b},), got {tuple(n_valid.shape)}")
        nv = n_valid.to(device=q.device, dtype=torch.int32).contiguous()
    bias_ptrs, gate_strides = (None, None), (0, 0, 0)
    if position_bias is not None:
        for name, x, shape in (("position_bias", position_bias, (h, t, t)),
                               ("gate", gate, (b, h, t))):
            if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != q.device:
                raise ValueError(f"flash_attention: {name} must be float32 {shape} on "
                                 f"{q.device}, got {x.dtype} {tuple(x.shape)} {x.device}")
        if not position_bias.is_contiguous():
            raise ValueError("flash_attention: position_bias must be contiguous")
        bias_ptrs, gate_strides = (position_bias.data_ptr(), gate.data_ptr()), gate.stride()

    lib = _library()
    group = 1
    if grouped and position_bias is None:
        group = lib.fadtk_flash_attention_pick_group(b, t, h, _DTYPE_CODE[q.dtype])
        if group < 1:
            raise RuntimeError(f"flash_attention: picking the group failed, cudaError {-group}")
    out = torch.empty_like(q)  # q's layout when q is dense, else contiguous
    strides = (ctypes.c_longlong * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *gate_strides
    )
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.fadtk_flash_attention_headmajor(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nv.data_ptr(), *bias_ptrs, out.data_ptr(),
        strides, b, t, h, group, _DTYPE_CODE[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed, cudaError {rc}")
    if position_bias is not None:
        flash_attention.bias_launches += 1
    elif group > 1:
        flash_attention.grouped_launches += 1
    else:
        flash_attention.launches += 1
    return out


# Kernel launches since the last reset, by form: ``launches`` counts the
# no-bias kernel, ``bias_launches`` the factorized-bias one, and for K2
# ``grouped_launches`` the grouped grid (``chip_smoke.py`` zeroes them and
# reads them around the main path to show the path went through the
# kernels).
flash_attention_packed.launches = 0
flash_attention_packed.bias_launches = 0
flash_attention.launches = 0
flash_attention.bias_launches = 0
flash_attention.grouped_launches = 0
