"""The float32 attention's bias and softmax in one pass: the hand-written Hopper kernel and its plain twin.

``attention_softmax(logits, bias, gate, position_bias)`` takes the float32
logits ``q·kᵀ/√d`` (B, H, T, T) of the speech encoders' plain attention
(``models/speech/encoder.py::_attention_core``) and returns
``softmax(logits + bias)`` over the keys. On the card the bias is the
additive key mask (B, 1, 1, T) and, for WavLM, its gated relative-position
bias in factorized form, ``gate`` (B, T, H) times the table ``position_bias``
(H, T, T):

    key_bias + gate ⊙ position_bias        (``dense_gated_bias``)

Its kernel (``fadtk_tpu_torch/csrc/attention_softmax.cu``; its header says
what bounds it and how it is laid out) is a port-only kernel: the JAX package
has no Pallas counterpart, since XLA fuses the bias and the softmax there. It
reads each row of logits once, adds the bias in registers in the order and
rounding of the torch composition, and writes the probabilities back over
the logits, so no dense (B, H, T, T) bias or second logits term is ever made.

Which of the two runs is decided here, by the tensor's device alone
(``_attention_core`` does not branch):

- CPU tensors go to ``attention_softmax_reference``, the torch composition,
  which returns a new tensor and takes any bias broadcastable to the logits
  (the CPU's WavLM passes the dense one, the JAX package's parity path);
- CUDA tensors launch the kernel, which overwrites ``logits`` and returns
  it, or raise. There is no fallback.

Either way the caller must not read ``logits`` again.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from . import build

_SOURCE = build.CSRC / "attention_softmax.cu"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# The longest row the kernel takes (``kMaxT`` in the source). The speech
# models cut a clip at six minutes, T = 18000 frames.
MAX_T = 32768


def library_path() -> Path:
    """Build (if needed) the kernel library and return its path."""
    return build.library_path(_SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(library_path()))
            fn = lib.fadtk_attention_softmax
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def dense_gated_bias(key_bias: torch.Tensor, gate: torch.Tensor,
                     position_bias: torch.Tensor) -> torch.Tensor:
    """WavLM's dense additive bias, (B, H, T, T): ``key_bias`` (B, 1, 1, T)
    plus ``gate`` (B, T, H) ⊙ ``position_bias`` (H, T, T), the product
    rounded first, in the inputs' dtype."""
    return key_bias + gate.transpose(1, 2)[..., None] * position_bias[None]


def attention_softmax_reference(logits: torch.Tensor, bias: torch.Tensor,
                                gate: torch.Tensor | None = None,
                                position_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch twin: ``softmax(logits + bias)`` in float32, with ``bias``
    any additive term broadcastable to the logits; with ``gate`` and
    ``position_bias``, ``dense_gated_bias(bias, gate, position_bias)``."""
    if gate is not None:
        bias = dense_gated_bias(bias, gate, position_bias)
    return torch.softmax(logits + bias.float(), dim=-1)


def _check(logits, key_bias, gate, position_bias) -> None:
    if logits.dtype != torch.float32 or logits.dim() != 4 or logits.shape[-1] != logits.shape[-2]:
        raise ValueError("attention_softmax: logits must be float32 (B, H, T, T), got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("attention_softmax: logits must be contiguous")
    b, h, t, _ = logits.shape
    want = [("key_bias", key_bias, (b, 1, 1, t))]
    if (gate is None) != (position_bias is None):
        raise ValueError("attention_softmax: gate and position_bias come together")
    if gate is not None:
        want += [("gate", gate, (b, t, h)), ("position_bias", position_bias, (h, t, t))]
    for name, x, shape in want:
        if (tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != logits.device
                or not x.is_contiguous()):
            raise ValueError(f"attention_softmax: {name} must be contiguous float32 {shape} on "
                             f"{logits.device}, got {x.dtype} {tuple(x.shape)} {x.device}"
                             f"{'' if x.is_contiguous() else ', not contiguous'}")


def attention_softmax(logits: torch.Tensor, bias: torch.Tensor,
                      gate: torch.Tensor | None = None,
                      position_bias: torch.Tensor | None = None) -> torch.Tensor:
    """``softmax(logits + bias [+ gate ⊙ position_bias])`` over the last dim.

    CPU tensors run the plain twin. CUDA tensors launch the kernel in place
    over ``logits`` and return it, or raise: every operand float32 and
    contiguous, logits (B, H, T, T) with T <= ``MAX_T``, ``bias`` the key
    mask (B, 1, 1, T), gate (B, T, H), position_bias (H, T, T).
    """
    if logits.device.type == "cpu":
        return attention_softmax_reference(logits, bias, gate, position_bias)
    _check(logits, bias, gate, position_bias)
    b, h, t, _ = logits.shape
    if t > MAX_T:
        raise ValueError(f"attention_softmax: T={t}; the kernel takes rows up to {MAX_T}")
    if logits.device.type != "cuda":
        raise ValueError(f"attention_softmax: unsupported device {logits.device}")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = _library().fadtk_attention_softmax(
        logits.data_ptr(), bias.data_ptr(), None if gate is None else gate.data_ptr(),
        None if position_bias is None else position_bias.data_ptr(), b, h, t, stream)
    if rc != 0:
        raise RuntimeError(f"attention_softmax: kernel launch failed, cudaError {rc}")
    attention_softmax.launches += 1
    return logits


# Kernel launches since the last reset (the card tests and chip_smoke.py
# read it around a forward to show the path went through the kernel).
attention_softmax.launches = 0
