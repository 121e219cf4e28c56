"""Published peaks of one NVIDIA H100 SXM and the shape-based counts of the
port's hand-written kernels, for a later PR to report a kernel's
``<kernel>_roofline`` as a metric file of its own.

Frozen copy of chip_smoke.py's ``attention_bound``, ``resnet_bound``,
``log_mel_bound`` and ``log_mel_gemm_bound`` (commit d8bf949): their FLOP
and byte counts are kept as they are; the divisor is not. There float32
operations were divided by the 3xTF32 rate (165 TFLOP/s), under which a
sound kernel with fewer tensor-core passes could read over 100%. Here every
float32 operation is divided by the dense TF32 rate, 495 TFLOP/s, the
fastest any tensor-core path with float32 inputs runs, so no sound kernel
reads over 100%; bfloat16 by 989 TFLOP/s. Bytes by the 3.35 TB/s of HBM3.
The data sheet's rates assume the 700 W power limit: state the card's
limit beside a share.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HEAD_DIM = 64


def roofline(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take (seconds), and which bound sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    return {"flops": flops, "bytes": nbytes, "bound_s": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_bound(nv: list[int], t: int, heads: int, dtype: str, bias: bool) -> dict:
    """K1/K1b/K2 for one call: batch b needs its nv_b valid query rows
    against nv_b keys (q.k and p.v, 4 D FLOP a pair and head, plus the
    gate.pb multiply-add when biased) and reads those rows of q, k, v (and
    of gate); the output is written for all T rows; pb is batch-independent
    and read once, over the largest valid square."""
    item = 2 if dtype == "bfloat16" else 4
    hd = heads * HEAD_DIM
    rows = sum(nv)
    pairs = sum(n * n for n in nv) * heads
    flops = pairs * 4 * HEAD_DIM + (2 * pairs if bias else 0)
    nbytes = 3 * rows * hd * item + len(nv) * t * hd * item + 4 * len(nv)
    if bias:
        nbytes += 4 * heads * max(nv) ** 2 + 4 * rows * heads
    return roofline(flops, nbytes, dtype)


def resnet_bound(b: int, c: int, t: int, dtype: str) -> dict:
    """K4 for one fused residual block over (b, c, t): 6 C^2 FLOP a column
    over B T columns, against x read once and out written once plus the
    weights and biases read once."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 6 * c * c * t * b
    nbytes = (2 * b * c * t + 3 * c * c + 5 * c // 2) * item
    return roofline(flops, nbytes, dtype)


def log_mel_bound(n: int, w: int, f: int, m: int, in_bytes: int, bins: int,
                  mel_nnz: int) -> dict:
    """K3 for one call over n frames with the least work for the function:
    the window, a real FFT of 2 (F - 1) points as a complex FFT of half
    that, the split pass and the power over the used bins, and the mel
    product over the mel matrix's nonzeros; against the frames' source read
    once, the window, the twiddles, the mel matrix and the output written
    once, all float32."""
    p = f - 1
    flops = n * (w + 5 * p * math.log2(p) + 19 * bins + 2 * mel_nnz)
    nbytes = in_bytes + 4 * (2 * p + 4 * p + f * m) + 4 * n * m
    return roofline(flops, nbytes, "float32")


def log_mel_gemm_bound(n: int, w: int, f: int, m: int, in_bytes: int, fold: bool,
                       mel_nnz: int) -> dict:
    """The same call in the DFT-as-product formulation (halved where the
    bases fold), plus the mel product."""
    flops = 2 * n * w * f * (1 if fold else 2) + 2 * n * mel_nnz
    nbytes = in_bytes + 4 * (2 * w * f + f * m) + 4 * n * m
    return roofline(flops, nbytes, "float32")
