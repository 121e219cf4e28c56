#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fadtk_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card, the
CUDA toolkit and PyTorch built for CUDA. It builds the port's kernels from the
sources in the checkout and fails (non-zero exit, no result line) on any
failed check, on a machine without a usable card, or outside a checkout.

Phases:

1. environment: the card's name and power limit, torch and CUDA versions;
2. kernel build (nvcc, sm_90a): one nvcc per kernel source, all started
   together, timed;
3. every kernel against its plain twin on the card, at the main paths'
   shapes, with CUDA-event times of kernel and twin, one PyTorch library call
   for the same function where there is one (a yardstick the port never
   calls), and the roofline bound of the run's work (float32 operations at
   the 3xTF32 rate, the CUDA-core figure printed beside it):
   - K1, flash attention without bias: the w2v2/HuBERT 16 kHz bucket
     B=16/T=499/H=12 in bf16 and f32, MERT's 24 kHz bucket T=749 in bf16,
     ragged n_valid;
   - K1b, the same kernel with WavLM's factorized gated bias: B=16/T=499 in
     bf16 and f32 at H=12 (wavlm-base-plus) and bf16 at H=16 (wavlm-large);
   - K4, the fused SEANet residual block: the four call sites of one
     encodec-emb forward of 10 s clips at B=16 (C/T = 32/240000, 64/120000,
     128/30000, 256/6000, none a multiple of the kernel's tile) in f32
     (3xTF32) and bf16, both on the tensor cores, each site's time beside the
     unfused cuDNN chain's, plus small ragged cases (T = 1001 and the minimum
     T = 3); no single library call computes it;
   - K2, the head-major flash attention, the tensor-parallel path's kernel
     for WavLM: B=16/T=499 with the factorized bias in bf16 at H=12
     (wavlm-base-plus), H=16 (wavlm-large) and H=6 (a tp=2 shard) and in f32
     at H=12, without bias in bf16, in the grouped form (G heads per CTA) in
     bf16, and the bf16 bias case again through the strided head-split views
     of packed (B, T, H*D) tensors; ragged n_valid, SDPA on the same
     head-major tensors as the yardstick;
   - K3, the fused log-mel spectrogram: Whisper's geometry at B=16 (3000
     frames of 400 per 30 s window, read through the strided view of the
     reflect-padded signal, F=201, M=80) in ``log10_clamp``, with the
     even/odd fold of its periodic-window bases; ``ln_offset`` at VGGish's
     bases (W=400 in a 512-point DFT: no fold; F=257, M=64) on 256 x 96
     contiguous frames; ``db_clamp`` at CLAP's (W=1024, hop 480, F=513, M=64,
     48 kHz; folded) on B=16 x 1001 contiguous frames; the other two modes on
     Whisper's strided frames; ragged tiles (N = 1, 65, 130) through both
     templates. The library yardstick is the chain torch.stft (periodic
     Hann) -> abs()² -> mel matmul -> clamp/log on the same signal; the
     bound counts the folded DFT where the bases fold and the mel matrix's
     nonzeros;
4. full-width forwards (random weights from a seed) of w2v2-base,
   wavlm-base-plus and MERT-v1-95M (24 kHz, T=749): f32 on the card against
   f32 on the CPU, same weights, one 10 s clip; then batch-16 forward times
   for each (f32, bf16, bf16 with plain attention) and the device time by
   kernel from torch.profiler;
5. the codec families through their model classes, f32 on the card against
   f32 on the CPU, same weights: encodec-emb on one 10 s clip with the fused
   block's knob (FADTK_TPU_FUSED_RESNET) on and off, encodec-emb-48k on a
   2.5 s stereo clip (two 1 s segments and a tail), dac-44kHz on one 5 s
   window; then batch-16 10 s forwards of encodec-emb in f32 and bf16, each
   with the knob off and on (the A/B), bf16 also with the LSTM's weights
   left scattered by a bare ``.to(bfloat16)`` (the cast before
   ``models.base.cast_module``), and dac-44kHz forwards of 8 windows in f32
   and bf16, with the device time by kernel and the idle share; a cuDNN
   "weights are not part of single contiguous chunk" warning fails any
   bf16 encodec-emb forward of the model's own cast;
6. the mel families through their model classes, f32 on the card against
   f32 on the CPU, same weights: whisper-base on one 30 s window and vggish
   on one 5 s clip; then vggish's network on one cross-file batch of 256
   examples, and batch-16 forwards (frontend included) of whisper-base and
   of whisper-large, the widest published geometry (d=1280, 32+32 layers, 20
   heads; random weights drawn on the card), each in f32 and bf16, with the
   device time by kernel and the idle share;
7. the main paths through the CLI (``fadtk_tpu_torch.cli.main.main``) on two
   generated datasets of 16 WAV clips each (full 10 s and ragged 2-9 s clips,
   some at 44.1 kHz so the host resampler runs): w2v2-base and
   wavlm-base-plus in f32 and ``--bf16``, MERT-v1-95M ``--bf16`` (resampled to
   24 kHz), encodec-emb in f32 and ``--bf16`` with the knob on,
   encodec-emb-48k ``--bf16``, dac-44kHz ``--bf16``, whisper-base in f32 and
   ``--bf16`` and vggish ``--bf16``. Every kernel launch count is set to 0
   just before each run and read just after it: K1/K1b must launch 12 times
   per speech device batch, K4 (f32) or K4b (its bf16 tensor-core form) 4
   times per encodec-emb forward, K3 once per
   whisper forward, and no kernel elsewhere;
8. the device pipeline through the CLI (``--device-pipeline``: no embedding
   caches, statistics on the card) on the same two datasets: w2v2-base and
   wavlm-base-plus in f32 and ``--bf16``, and w2v2-base f32 with ``--batch 4``
   and a checkpoint every 4 files. K1 must launch 12 times per device batch
   for w2v2-base bf16 and K2 12 times per device batch for wavlm-base-plus
   bf16 (its tensor-parallel step at tp=1), no kernel elsewhere; the frame
   count must match the clips, the statistics the cached path's
   ``stats/<model>/`` and the score the cached path's, in f32 and bf16
   (``PIPE_TOL``); for w2v2-base f32 the gap is split into its sources
   (``scripts/torch_pipeline_gap_probe.py``); the pipeline's audio-s/s is
   printed beside the cached path's embed-stage rate;
9. one JSON line of kernel results, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
SR = 16000
HEAD_DIM, BATCH = 64, 16
# Tolerances, kernel vs plain twin on valid rows: in bf16 both round the
# unnormalised p to bf16 before the p·v product, at different running maxima
# and in a different order (about one bf16 ulp of the output); f32 differs
# only by the online softmax's reordered sums.
ATOL = {"bfloat16": 2e-2, "float32": 1e-5}
RTOL_CARD_VS_CPU = 1e-3
# K4 vs its plain twin, |kernel - twin| <= tol + tol·|twin| (the JAX package's
# tests/test_fused_resnet.py bounds): float32 runs as 3xTF32 (each product
# from TF32 hi and lo parts, ~2^-21 of its float32 value; the twin's cuDNN
# convs in float32, TF32 off) and measured within 7.5e-6 of the twin at
# |twin| <= 1.8 (C=256; 1.4e-6 at C=32), the CPU emulation of the same split
# within 1.1e-6; in bf16 the kernel and the twin round the same products to
# bf16, but cuDNN's tensor-core sums land on the other side of a rounding
# boundary now and then, one bf16 ulp (2^-8 relative) that moves through the
# next product.
K4_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# The four K4 call sites of one encodec-emb forward of 10 s clips (24 kHz):
# (C, T) after each downsampling stage; 4 launches per forward.
K4_SHAPES = [(32, 240000), (64, 120000), (128, 30000), (256, 6000)]
# K3 vs its twin on log values (tests/test_torch_fused_log_mel.py's card
# bounds): float32 FMA chains against cuBLAS's float32 GEMMs (TF32 off) sum
# in other orders; a relative error e of a mel value moves log10 by e/ln 10
# and the dB value by 10 times that. The torch.stft chain (cuFFT) is held to
# ten times these, as a check that it computes the same function.
K3_ATOL = {"ln_offset": 1e-4, "log10_clamp": 1e-4, "db_clamp": 1e-3}
# --device-pipeline vs the cached path on the same clips, per dataset. float32:
# mu and cov absolute (tests/test_torch_device_pipeline.py's bounds), score
# relative. The cached path's host statistics take each file's mean in
# float16, as the reference does (np.mean of the float16 .npy), which moves mu
# by up to half a float16 ulp (2.4e-4 at |mu| ~ 1; measured 2.5e-4) and cov
# through the merge's delta term (1.9e-4); scores agreed within 4.9e-6.
# bfloat16: the same clips through other kernels (the tp step sends WavLM to
# K2, the cached path to K1b) that round p to bf16 at other running maxima.
# Scores agreed within 4.9e-6 (w2v2-base) and 4.6e-6 (wavlm-base-plus)
# relative, and the four-card bf16 probe within 1.9e-4 (mu) and 8.5e-4 (cov)
# of the largest value: each bound is about ten times those.
PIPE_TOL = {"float32": {"mu": 1e-3, "cov": 5e-3, "score": 1e-3},
            "bfloat16": {"mu": 2e-3, "cov": 1e-2, "score": 5e-5}}
# Roofline of one H100 SXM (NVIDIA data sheet; dense, at 700 W): memory rate
# and peak rates by input type: bf16 on the tensor cores; float32 the faster
# of the CUDA cores (67 TFLOP/s) and 3xTF32 on the tensor cores, three TF32
# products (495 TFLOP/s) of error-compensated operands for one float32-accurate
# product, 165 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(torch, fn, runs: int = 25, groups: int = 5) -> float:
    """Time per call (ms), after two warm-up calls: the median over
    ``groups`` of the CUDA-event time of ``runs // groups`` back-to-back
    calls, divided by their number. Back to back, the host enqueues the next
    call while the card runs this one, so a short kernel's time excludes its
    wrapper's Python checks (an event pair around each single call counts
    them as idle card time)."""
    for _ in range(2):
        fn()
    groups = min(groups, runs)
    per = runs // groups
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def _roofline(flops: float, nbytes: float, dtype: str) -> dict:
    """The larger of the bytes over the memory rate and the operations over the
    peak rate for the input type, in ms, and which of the two it is. float32
    operations take the smaller of their time on the CUDA cores and as 3xTF32
    (three times the operations at the TF32 rate)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if dtype == "float32":
        by_ops = min(by_ops, 3 * flops / PEAK_FLOPS["tf32"] * 1e3)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cuda_core_note(flops: float, nbytes: float, dtype: str) -> str:
    """For float32, the bound with the operations on the CUDA cores, printed
    beside the one that counts them at the 3xTF32 rate."""
    if dtype != "float32":
        return ""
    us = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]) * 1e6
    return f"; on the CUDA cores {us:.2f} us"


def attention_bound(nv: list[int], t: int, heads: int, dtype: str, bias: bool) -> dict:
    """The least time the card could take for this call's work: the larger of
    the bytes it must move over the memory rate and its operations over the
    peak rate for the input type. Data-dependent, as this run's n_valid
    makes it: batch b needs its nv_b valid query rows against nv_b keys
    (q·k and p·v, 4·D FLOP per pair and head, plus the gate·pb multiply-add
    when biased) and reads those rows of q, k, v (and of gate); the output is
    written for all T rows; pb is batch-independent and read once, over the
    largest valid square."""
    item = 2 if dtype == "bfloat16" else 4
    hd = heads * HEAD_DIM
    rows = sum(nv)
    pairs = sum(n * n for n in nv) * heads
    flops = pairs * 4 * HEAD_DIM + (2 * pairs if bias else 0)
    nbytes = 3 * rows * hd * item + len(nv) * t * hd * item + 4 * len(nv)
    if bias:
        nbytes += 4 * heads * max(nv) ** 2 + 4 * rows * heads
    return {**_roofline(flops, nbytes, dtype), "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


def check_kernel(torch, fa, dtype, t: int, heads: int, bias: bool) -> dict:
    """Kernel vs twin at (BATCH, t, heads*HEAD_DIM) with ragged n_valid; with
    ``bias``, random pb (H, T, T) ~ N(0, 1) and gate (B, T, H) in [1, 3].
    Times kernel, twin and ``F.scaled_dot_product_attention`` on the
    head-major views (boolean key mask; with ``bias``, the dense float mask
    gate·pb + key mask, built before the timed region and not timed)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    name = str(dtype).split(".")[-1]
    g = torch.Generator(device=dev).manual_seed(SEED + t + heads)
    shape = (BATCH, t, heads * HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    nv_list = [min(n, t) for n in
               [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]]
    nv = torch.tensor(nv_list, dtype=torch.int32, device=dev)
    extra = (None, None)
    if bias:
        pb = torch.randn((heads, t, t), generator=g, device=dev)
        gate = torch.rand((BATCH, t, heads), generator=g, device=dev) * 2.0 + 1.0
        extra = (pb, gate)

    out = fa.flash_attention_packed(q, k, v, nv, *extra, num_heads=heads)
    ref = fa.flash_attention_packed_reference(q, k, v, nv, *extra, num_heads=heads)
    torch.cuda.synchronize()
    label = f"{'K1b' if bias else 'K1'} {name} B={BATCH} T={t} H={heads}"
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{label}: non-finite values in the kernel output")
    err = 0.0
    for b, n in enumerate(nv_list):
        err = max(err, (out[b, :n].float() - ref[b, :n].float()).abs().max().item())
        dead = -(-n // 64) * 64  # first fully padded 64-row tile
        if dead < t and out[b, dead:].abs().max().item() != 0.0:
            raise AssertionError(f"{label} b={b}: fully padded tile not zero")
    tol = ATOL[name]

    def heads_view(x):
        return x.view(BATCH, t, heads, HEAD_DIM).transpose(1, 2)

    qh, kh, vh = heads_view(q), heads_view(k), heads_view(v)
    key_live = torch.arange(t, device=dev)[None, :] < nv[:, None].long()
    if bias:
        neg = torch.finfo(torch.float32).min
        mask = gate.transpose(1, 2)[..., None] * pb[None]
        mask = mask.masked_fill(~key_live[:, None, None, :], neg).to(dtype)
    else:
        mask = key_live[:, None, None, :]
    ms = cuda_ms(torch, lambda: fa.flash_attention_packed(q, k, v, nv, *extra, num_heads=heads))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_packed_reference(
        q, k, v, nv, *extra, num_heads=heads))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    full = torch.full_like(nv, t)
    full_ms = cuda_ms(torch, lambda: fa.flash_attention_packed(
        q, k, v, full, *extra, num_heads=heads))
    bound = attention_bound(nv_list, t, heads, name, bias)
    print(f"{label}: max_abs_err={err:.3e} (atol {tol:g}); ragged n_valid: kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms (mask prebuilt, untimed); "
          f"bound {bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
          f"({bound['gflop']:.3f} GFLOP, {bound['mbytes']:.2f} MB"
          f"{cuda_core_note(bound['gflop'] * 1e9, bound['mbytes'] * 1e6, name)}); "
          f"all keys valid: kernel={full_ms:.4f} ms", flush=True)
    del mask, ref, out
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs twin max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": library_ms}


def check_k2(torch, fa, dtype, heads: int, form: str, strided: bool = False) -> dict:
    """K2 vs its twin at (BATCH, heads, 499, HEAD_DIM), head-major, with the
    ragged n_valid of ``check_kernel``. ``form``: "bias" (pb (H, T, T) ~
    N(0, 1), gate (B, H, T) in [1, 3]), "plain" or "grouped" (no bias, G
    heads per CTA). ``strided``: q, k, v are the head-split views of packed
    (B, T, H*D) tensors, as the tensor-parallel path passes them. Times the
    kernel, the twin and ``F.scaled_dot_product_attention`` on the same
    tensors (with bias, the dense float mask built untimed)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    t = 499
    name = str(dtype).split(".")[-1]
    g = torch.Generator(device=dev).manual_seed(SEED + heads + len(form))
    if strided:
        q, k, v = (torch.randn((BATCH, t, heads * HEAD_DIM), generator=g, device=dev).to(dtype)
                   .view(BATCH, t, heads, HEAD_DIM).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (torch.randn((BATCH, heads, t, HEAD_DIM), generator=g, device=dev).to(dtype)
                   for _ in range(3))
    nv_list = [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
    nv = torch.tensor(nv_list, dtype=torch.int32, device=dev)
    extra = (None, None)
    if form == "bias":
        pb = torch.randn((heads, t, t), generator=g, device=dev)
        gate = torch.rand((BATCH, heads, t), generator=g, device=dev) * 2.0 + 1.0
        extra = (pb, gate)
    grouped = form == "grouped"
    counter = {"bias": "bias_launches", "grouped": "grouped_launches", "plain": "launches"}[form]
    before = getattr(fa.flash_attention, counter)
    out = fa.flash_attention(q, k, v, nv, *extra, grouped=grouped)
    ref = fa.flash_attention_reference(q, k, v, nv, *extra)
    torch.cuda.synchronize()
    label = f"K2 {form} {name} B={BATCH} T={t} H={heads}" + (" (strided views)" if strided else "")
    if getattr(fa.flash_attention, counter) != before + 1:
        raise AssertionError(f"{label}: the {counter} counter did not count the launch")
    if out.shape != q.shape or out.stride() != q.stride() or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{label}: {tuple(out.shape)} {out.stride()} or non-finite values")
    err = 0.0
    for b, n in enumerate(nv_list):
        err = max(err, (out[b, :, :n].float() - ref[b, :, :n].float()).abs().max().item())
        dead = -(-n // 64) * 64
        if dead < t and out[b, :, dead:].abs().max().item() != 0.0:
            raise AssertionError(f"{label} b={b}: fully padded tile not zero")
    tol = ATOL[name]
    key_live = torch.arange(t, device=dev)[None, :] < nv[:, None].long()
    if form == "bias":
        neg = torch.finfo(torch.float32).min
        mask = (gate[..., None] * pb[None]).masked_fill(~key_live[:, None, None, :], neg).to(dtype)
    else:
        mask = key_live[:, None, None, :]
    ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, nv, *extra, grouped=grouped))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_reference(q, k, v, nv, *extra))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    bound = attention_bound(nv_list, t, heads, name, form == "bias")
    group = ""
    if grouped:
        code = {"float32": 0, "bfloat16": 1}[name]
        group = f"; G={fa._library().fadtk_flash_attention_pick_group(BATCH, t, heads, code)}"
    print(f"{label}: max_abs_err={err:.3e} (atol {tol:g}){group}; kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms (mask prebuilt, untimed); "
          f"bound {bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
          f"({bound['gflop']:.3f} GFLOP, {bound['mbytes']:.2f} MB"
          f"{cuda_core_note(bound['gflop'] * 1e9, bound['mbytes'] * 1e6, name)})", flush=True)
    del mask, ref, out
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs twin max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": library_ms}


def k2_checks(torch, fa) -> tuple[dict, dict]:
    """K2 in every form at the main path's shapes; returns the kernels-line
    entries of the bf16 bias case at H=12 and of the grouped case."""
    bias = check_k2(torch, fa, torch.bfloat16, 12, "bias")
    check_k2(torch, fa, torch.bfloat16, 16, "bias")
    check_k2(torch, fa, torch.bfloat16, 6, "bias")
    check_k2(torch, fa, torch.float32, 12, "bias")
    check_k2(torch, fa, torch.bfloat16, 12, "plain")
    grouped = check_k2(torch, fa, torch.bfloat16, 12, "grouped")
    strided = check_k2(torch, fa, torch.bfloat16, 12, "bias", strided=True)
    print(f"K2 bf16 bias H=12, contiguous / strided views: {bias['ms']:.4f} / "
          f"{strided['ms']:.4f} ms", flush=True)
    return bias, grouped


def resnet_bound(b: int, c: int, t: int, dtype: str) -> dict:
    """The least time the card could take for one fused residual block over
    (b, c, t): 6·C² FLOP per column (3·C² for the k=3 conv, C² for the k=1
    conv, 2·C² for the shortcut) over B·T columns at the peak rate for the
    input type, against x read once and out written once (2·B·C·T items)
    plus the weights and biases (3·C² + 2.5·C items) read once."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 6 * c * c * t * b
    nbytes = (2 * b * c * t + 3 * c * c + 5 * c // 2) * item
    return {"flops": flops, "bytes": nbytes, **_roofline(flops, nbytes, dtype)}


def check_resnet(torch, fr, dtype, c: int, t: int, b: int = BATCH, timed: bool = True) -> dict:
    """K4 vs its twin on (b, c, t): x ~ N(0, 0.5²); weights U(±1/√fan_in) as
    the model's random init makes them, biases U(±0.1). With ``timed``, the
    CUDA-event times of kernel and twin (the unfused cuDNN chain)."""
    dev = torch.device("cuda")
    name = str(dtype).split(".")[-1]
    g = torch.Generator(device=dev).manual_seed(SEED + c + t)
    x = (torch.randn((b, c, t), generator=g, device=dev) * 0.5).to(dtype)

    def u(shape, s):
        return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * s).to(dtype)

    ch = c // 2
    w = (u((ch, c, 3), (3 * c) ** -0.5), u((ch,), 0.1), u((c, ch), ch ** -0.5), u((c,), 0.1),
         u((c, c), c ** -0.5), u((c,), 0.1))
    out = fr.fused_resnet_causal(x, *w)
    ref = fr.fused_resnet_causal_reference(x, *w)
    torch.cuda.synchronize()
    label = f"K4 {name} B={b} C={c} T={t}"
    if out.shape != x.shape or out.dtype != x.dtype or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{label}: {out.dtype} {tuple(out.shape)} or non-finite values")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    tol = K4_TOL[name]
    over = (diff > tol + tol * ref.float().abs()).sum().item()
    del diff, out
    result = {"max_abs_err": err, "max_ref": ref.float().abs().max().item()}
    del ref
    line = (f"{label}: max_abs_err={err:.3e} (max|twin| {result['max_ref']:.3f}; "
            f"atol=rtol={tol:g}, {over} over)")
    if timed:
        ms = cuda_ms(torch, lambda: fr.fused_resnet_causal(x, *w))
        plain_ms = cuda_ms(torch, lambda: fr.fused_resnet_causal_reference(x, *w))
        bound = resnet_bound(b, c, t, name)
        result.update(ms=ms, plain_ms=plain_ms, **bound)
        line += (f"; kernel={ms:.4f} ms plain={plain_ms:.4f} ms (no single library call); "
                 f"bound {bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
                 f"({bound['flops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.2f} MB"
                 f"{cuda_core_note(bound['flops'], bound['bytes'], name)})")
    print(line, flush=True)
    if over:
        raise AssertionError(f"{label}: {over} values beyond the tolerance, max_abs_err {err}")
    return result


def k4_path_checks(torch, fr) -> dict:
    """K4 at the four call sites in f32 and bf16, and the ragged cases.
    Returns the kernels-line entries, by dtype, for one forward's four
    launches: the summed kernel and twin times, the bound of the summed work,
    the largest error."""
    torch.backends.cudnn.allow_tf32 = False  # the f32 twin's convs stay f32
    per = {name: [check_resnet(torch, fr, dtype, c, t) for c, t in K4_SHAPES]
           for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
    for dtype in (torch.float32, torch.bfloat16):
        check_resnet(torch, fr, dtype, 64, 1001, b=3, timed=False)
        check_resnet(torch, fr, dtype, 32, 3, b=2, timed=False)
    summed = {}
    for name, rows in per.items():
        flops, nbytes = sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows)
        summed[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            **_roofline(flops, nbytes, name),
            "library_ms": None,
        }
        faster = all(r["ms"] < r["plain_ms"] for r in rows)
        print(f"K4 {name}, the four launches of one batch-16 forward: {summed[name]}; faster "
              f"than the cuDNN chain at every site: {faster}; kernel / chain "
              f"{summed[name]['ms'] / summed[name]['plain_ms']:.3f}"
              f"{cuda_core_note(flops, nbytes, name)}", flush=True)
    return summed


def log_mel_bound(n: int, w: int, f: int, m: int, in_bytes: int, fold: bool,
                  mel_nnz: int) -> dict:
    """The least time the card could take for one fused log-mel call over n
    frames: the DFT products at the f32 rate, 2·N·W·2F FLOP, or half that
    (2·N·F·W) where the bases fold (a periodic window with W = n_fft:
    ``dre[W-n] = dre[n]``, ``dim[W-n] = -dim[n]``), plus the mel product over
    the mel matrix's nonzeros (2·N·nnz), against the frames' source read once
    (``in_bytes``: the padded signal for the strided view, the (N, W) frames
    otherwise), the bases and the mel matrix read once and the (N, M) output
    written once, all float32."""
    flops = 2 * n * w * f * (1 if fold else 2) + 2 * n * mel_nnz
    nbytes = in_bytes + 4 * (2 * w * f + f * m) + 4 * n * m
    return {"flops": flops, "bytes": nbytes, **_roofline(flops, nbytes, "float32")}


def check_log_mel(torch, k3, label: str, frames, bases, log_mode: str, log_offset: float = 0.0,
                  in_bytes: int | None = None, library=None) -> dict:
    """K3 vs its twin on ``frames``; with ``library`` (the torch.stft chain
    on the frames' signal), also that chain's agreement, and the CUDA-event
    times of kernel, twin and chain beside the bound."""
    def kernel():
        return k3.fused_log_mel(frames, *bases, log_mode=log_mode, log_offset=log_offset)

    def twin():
        return k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode,
                                          log_offset=log_offset)

    out, ref = kernel(), twin()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
    err = (out - ref).abs().max().item()
    tol = K3_ATOL[log_mode]
    line = (f"{label}: {tuple(out.shape)} max_abs_err={err:.3e} (atol {tol:g}; "
            f"max|twin| {ref.abs().max().item():.3f})")
    result = {"max_abs_err": err}
    if library is not None:
        lib_err = (library().reshape(ref.shape) - ref).abs().max().item()
        ms, plain_ms, library_ms = (cuda_ms(torch, fn) for fn in (kernel, twin, library))
        w, f, m = frames.shape[-1], bases[0].shape[1], bases[2].shape[1]
        layout = k3.kernel_layout(*bases)
        bound = log_mel_bound(ref.numel() // m, w, f, m, in_bytes, layout.fold,
                              int((bases[2] != 0).sum()))
        old = log_mel_bound(ref.numel() // m, w, f, m, in_bytes, False, f * m)
        result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                      bound_by=bound["bound_by"], library_ms=library_ms)
        line += (f"; stft chain vs twin {lib_err:.3e}; kernel={ms:.4f} ms plain={plain_ms:.4f} "
                 f"ms stft chain={library_ms:.4f} ms; bases fold: {layout.fold}; bound "
                 f"{bound['bound_ms'] * 1e3:.2f} us by {bound['bound_by']} "
                 f"({bound['flops'] / 1e9:.3f} GFLOP, {bound['bytes'] / 1e6:.2f} MB"
                 f"{cuda_core_note(bound['flops'], bound['bytes'], 'float32')}; unfolded "
                 f"DFT and dense mel product: {old['bound_ms'] * 1e3:.2f} us)")
        if not lib_err <= 10 * tol:
            raise AssertionError(f"{label}: the stft chain differs from the twin by {lib_err}")
    print(line, flush=True)
    del out, ref
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs twin max_abs_err {err} > {tol}")
    return result


def k3_path_checks(torch, k3) -> dict:
    """K3 in its three modes at the mel families' geometries, and ragged
    tiles. Returns the kernels-line entry of Whisper's B=16 call."""
    import torch.nn.functional as F

    from fadtk_tpu_torch.dsp import mel as dmel

    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's GEMMs stay f32
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def stft_power(x, n_fft, hop, win_length, center):
        window = torch.hann_window(win_length, periodic=True, device=dev)
        spec = torch.stft(x, n_fft, hop, win_length=win_length, window=window, center=center,
                          pad_mode="reflect", return_complex=True)
        return spec.abs() ** 2  # (..., F, frames)

    # Whisper: 16 windows of 30 s, frames read through the strided view.
    audio = torch.randn((BATCH, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1
    wb = dmel._device_bases("whisper", dev)
    whisper = check_log_mel(
        torch, k3, f"K3 log10_clamp Whisper B={BATCH} (strided view)",
        dmel.whisper_frames(audio), wb, "log10_clamp",
        in_bytes=4 * BATCH * (dmel.WHISPER_SAMPLES + 400),
        library=lambda: torch.log10(torch.clamp_min(
            stft_power(audio, 400, 160, 400, True)[..., :-1].transpose(1, 2) @ wb[2], 1e-10)))

    # VGGish's bases: one cross-file batch of 256 examples of 96 frames from
    # one signal, VALID framing. torch.stft centres the 400-sample window in
    # its 512-sample frame, so the signal gets 56 zeros on each side.
    n = 256 * 96
    sig = torch.randn(((n - 1) * 160 + 400,), generator=g, device=dev) * 0.1
    frames = sig.unfold(0, 400, 160).contiguous()
    vb = dmel._device_bases("vggish", dev)
    padded = F.pad(sig, (56, 56))
    check_log_mel(torch, k3, f"K3 ln_offset VGGish bases N={n}", frames, vb, "ln_offset", 0.01,
                  in_bytes=4 * frames.numel(),
                  library=lambda: torch.log(
                      stft_power(padded, 512, 160, 400, False).T @ vb[2] + 0.01))

    # CLAP's (laion, 48 kHz): 16 windows of 10 s, centred reflect framing.
    clap = torch.randn((BATCH, 480000), generator=g, device=dev) * 0.1
    frames = F.pad(clap[:, None], (512, 512), mode="reflect")[:, 0].unfold(-1, 1024, 480)
    frames = frames.contiguous().reshape(-1, 1024)
    cb = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    check_log_mel(torch, k3, f"K3 db_clamp CLAP bases N={frames.shape[0]}", frames, cb,
                  "db_clamp", in_bytes=4 * frames.numel(),
                  library=lambda: 10.0 * torch.log10(torch.clamp_min(
                      stft_power(clap, 1024, 480, 1024, True).transpose(1, 2) @ cb[2], 1e-10)))
    del audio, sig, frames, padded, clap

    # The other two modes on Whisper's strided frames, and ragged frame tiles
    # (three clips) through both templates.
    wf = dmel.whisper_frames(torch.randn((2, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1)
    for mode, offset in (("ln_offset", 0.01), ("db_clamp", 0.0)):
        check_log_mel(torch, k3, f"K3 {mode} Whisper B=2 (strided view)", wf, wb, mode, offset)
    for n in (1, 65, 130):
        check_log_mel(torch, k3, f"K3 log10_clamp ragged B=3 N={n} (folded)",
                      torch.randn((3, n, 400), generator=g, device=dev) * 0.1, wb, "log10_clamp")
        check_log_mel(torch, k3, f"K3 ln_offset ragged B=3 N={n} (VGGish bases, unfolded)",
                      torch.randn((3, n, 400), generator=g, device=dev) * 0.1, vb, "ln_offset",
                      0.01)
    return whisper


def card_vs_cpu(torch, model_name: str):
    """Full-width f32 forward of ``model_name``'s encoder on the card vs the
    CPU, same weights, one 10 s clip. Returns the card model."""
    import copy

    import numpy as np

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.models.speech.encoder import (
        SpeechEncoder,
        init_speech_encoder,
        speech_encoder_forward,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = get_model(model_name)
    cfg, n_samples = model.cfg, 10 * model.sr
    cpu_model = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(SEED)).eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy((rng.standard_normal((1, n_samples)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, mask = speech_encoder_forward(cpu_model, audio, taps=(cfg.num_layers,))
        cpu_s = time.perf_counter() - t0
        got, gmask = speech_encoder_forward(gpu_model, audio.cuda(), taps=(cfg.num_layers,))
        got = got.cpu()
    n = int(mask.sum())
    if n != cfg.num_output_frames(n_samples) or int(gmask.sum()) != n:
        raise AssertionError(f"frame count {n} / {int(gmask.sum())}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite card output")
    diff = (got - want)[..., :n, :].abs().max().item()
    scale = want[..., :n, :].abs().max().item()
    print(f"{model_name} f32 card vs cpu, 1 x 10 s, {n} frames x {cfg.hidden_size}: "
          f"max_abs_diff={diff:.3e} max|cpu|={scale:.3e} relative={diff / scale:.3e} "
          f"(limit {RTOL_CARD_VS_CPU:g}); cpu forward {cpu_s:.2f} s", flush=True)
    if not diff <= RTOL_CARD_VS_CPU * scale:
        raise AssertionError(f"card vs cpu relative diff {diff / scale} > {RTOL_CARD_VS_CPU}")
    return gpu_model, model.sr


def forward_breakdown(torch, m32, model_name: str, sr: int) -> None:
    """Batch-16 forwards of the 10 s bucket (8 full clips, 8 ragged): median
    CUDA-event time in f32, bf16, and bf16 with the plain attention instead of
    the kernel; then device time by kernel from torch.profiler. Also warms up
    the libraries before the timed CLI runs."""
    import copy

    from fadtk_tpu_torch.models.speech.encoder import speech_encoder_forward

    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = 10 * sr
    audio = torch.randn((BATCH, n), generator=g, device="cuda") * 0.1
    nv = torch.tensor([n] * 8 + [n * (i + 2) // 10 for i in range(8)], dtype=torch.int32,
                      device="cuda")
    audio_s = nv.sum().item() / sr
    tap = m32.cfg.num_layers

    def forward(model):
        with torch.inference_mode():
            return speech_encoder_forward(model, audio, nv, taps=(tap,))

    for name, model, flash in (("f32", m32, ""), ("bf16", m16, ""),
                               ("bf16 plain attention", m16, "0")):
        os.environ["FADTK_TPU_FLASH_ATTENTION"] = flash
        ms = cuda_ms(torch, lambda: forward(model), runs=10)
        print(f"{model_name} forward {name}: {ms:.3f} ms per batch of 16 = "
              f"{audio_s / ms * 1e3:.1f} audio-s/s ({audio_s:.1f} s of valid audio in the "
              "10 s bucket)", flush=True)
    os.environ.pop("FADTK_TPU_FLASH_ATTENTION")

    for name, model in (("f32", m32), ("bf16", m16)):
        profile_forward(torch, f"{model_name} {name}", lambda: forward(model))


def profile_forward(torch, label: str, forward) -> None:
    """One forward under torch.profiler: wall time, device kernel time, idle
    share and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(kernels.values())
    if not busy:
        print(f"[{label}] device time by kernel: not measured (no device events)")
        return
    print(f"[{label}] one forward: wall {wall_ms:.2f} ms, device kernels "
          f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}; top kernels:", flush=True)
    for k, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t:8.3f} ms {100 * t / busy:5.1f}%  {k[:100]}", flush=True)


def model_card_vs_cpu(torch, model_name: str, audio, knobs=("",)):
    """``model_name``'s ``_embed`` (its own windowing, segmenting or
    frontend) in f32 on the card vs the CPU, random weights from seed 0 in
    both, once for each value of FADTK_TPU_FUSED_RESNET in ``knobs``.
    Returns the card model."""
    from fadtk_tpu_torch.models.registry import get_model

    models = {}
    for dev in ("cpu", "cuda"):
        os.environ["FADTK_TPU_TORCH_DEVICE"] = dev
        models[dev] = get_model(model_name)
        models[dev].ensure_loaded()
    os.environ.pop("FADTK_TPU_TORCH_DEVICE")
    t0 = time.perf_counter()
    want = models["cpu"]._embed(audio)
    cpu_s = time.perf_counter() - t0
    scale = float(abs(want).max())
    for knob in knobs:
        os.environ["FADTK_TPU_FUSED_RESNET"] = knob
        got = models["cuda"]._embed(audio)
        os.environ.pop("FADTK_TPU_FUSED_RESNET")
        if got.shape != want.shape or not (abs(got) < float("inf")).all():
            raise AssertionError(f"{model_name}: card {got.shape} vs cpu {want.shape}, "
                                 "or non-finite values")
        diff = float(abs(got - want).max())
        print(f"{model_name} f32 card vs cpu, audio {tuple(audio.shape)}, "
              f"FADTK_TPU_FUSED_RESNET={knob!r}: {got.shape[0]} frames x {got.shape[1]}: "
              f"max_abs_diff={diff:.3e} max|cpu|={scale:.3e} relative={diff / scale:.3e} "
              f"(limit {RTOL_CARD_VS_CPU:g}); cpu {cpu_s:.2f} s", flush=True)
        if not diff <= RTOL_CARD_VS_CPU * scale:
            raise AssertionError(f"{model_name}: card vs cpu relative diff {diff / scale}")
    return models["cuda"]


RNN_COMPACTION = "not part of single contiguous chunk of memory"


@contextlib.contextmanager
def rnn_warnings(label: str, allowed: bool = False):
    """Record every warning inside the block; unless ``allowed``, fail on
    cuDNN's "RNN module weights are not part of single contiguous chunk of
    memory" (an LSTM whose weights were not re-flattened after a cast,
    compacted again at every call). Yields the list of those warnings."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        found: list[str] = []
        yield found
    found.extend(str(w.message) for w in seen if RNN_COMPACTION in str(w.message))
    if found and not allowed:
        raise AssertionError(f"{label}: {len(found)} LSTM weight compaction warnings")


def module_forward_breakdown(torch, model, forward, shape: tuple, audio_s: float, unit: str,
                            knobs=("",), lstm_ab: bool = False) -> None:
    """Forwards of ``model``'s module on a random input of ``shape`` (audio
    (B, channels, T), or vggish's (N, 96, 64) examples) in f32 and bf16, each
    with every knob value: median CUDA-event time, then one profiled forward
    each. The bf16 module is cast as the model casts it (its LSTM weights
    re-flattened), and a compaction warning fails the run; with ``lstm_ab``,
    a bf16 module cast with a bare ``.to(bfloat16)`` (scattered LSTM weights)
    runs first, for the before/after of the flattening."""
    import copy

    from fadtk_tpu_torch.models.base import cast_module

    m32 = model.module
    variants = [("f32", m32, False), ("bf16", cast_module(copy.deepcopy(m32), torch.bfloat16),
                                      False)]
    if lstm_ab:
        variants.insert(1, ("bf16 LSTM not re-flattened",
                            copy.deepcopy(m32).to(torch.bfloat16), True))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    audio = torch.randn(shape, generator=g, device="cuda") * 0.1

    def run(module):
        with torch.inference_mode():
            return forward(module, audio)

    for name, module, allowed in variants:
        for knob in knobs:
            os.environ["FADTK_TPU_FUSED_RESNET"] = knob
            label = f"{model.name} {name} B={shape[0]}" + (f" fused={knob}" if knob else "")
            with rnn_warnings(label, allowed) as found:
                ms = cuda_ms(torch, lambda: run(module), runs=10)
                print(f"{label}: forward {ms:.3f} ms = {audio_s / ms * 1e3:.1f} {unit}/s "
                      f"({audio_s:g} {unit} per batch)", flush=True)
                profile_forward(torch, label, lambda: run(module))
            if allowed:
                print(f"{label}: {len(found)} LSTM weight compaction warnings", flush=True)
            os.environ.pop("FADTK_TPU_FUSED_RESNET")
    del variants


def whisper_forward_breakdown(torch, size: str, module=None, runs: int = 10) -> None:
    """Batch-16 forwards of 30 s windows, frontend (K3) included: median
    CUDA-event time in f32 and bf16, then one profiled forward each. Without
    ``module``, random weights drawn on the card from the seed (whisper-large
    has 1.55 B parameters)."""
    import copy

    from fadtk_tpu_torch.dsp.mel import WHISPER_SAMPLES, whisper_log_mel
    from fadtk_tpu_torch.models import whisper_impl as wi

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if module is None:
        t0 = time.perf_counter()
        with torch.device("cuda"):
            module = wi.Whisper(wi.config_for_size(size))
        wi.init_whisper_params(module, torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in module.parameters())
        print(f"whisper-{size}: {n_params / 1e9:.3f} B random parameters drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    m16 = copy.deepcopy(module).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    audio = torch.randn((BATCH, WHISPER_SAMPLES), generator=g, device="cuda") * 0.1

    def run(m):
        with torch.inference_mode():
            return wi.whisper_forward(m, whisper_log_mel(audio))

    for name, m in (("f32", module), ("bf16", m16)):
        out = run(m)
        if out.shape != (BATCH, 2, m.cfg.d_model) or not torch.isfinite(out).all():
            raise AssertionError(f"whisper-{size} {name}: {tuple(out.shape)} or non-finite")
        ms = cuda_ms(torch, lambda: run(m), runs=runs)
        print(f"whisper-{size} forward {name}: {ms:.3f} ms per batch of {BATCH} x 30 s = "
              f"{BATCH * 30 / ms * 1e3:.1f} window-s/s", flush=True)
        profile_forward(torch, f"whisper-{size} {name} B={BATCH}", lambda: run(m))
    del m16, module


def make_dataset(root: Path, name: str, seed: int) -> float:
    """16 WAV clips: 8 full 10 s, 8 ragged 2-9 s; every 4th at 44.1 kHz.
    Returns the total seconds of audio."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

    d = root / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    total = 0.0
    for i in range(16):
        sr = 44100 if i % 4 == 3 else SR
        seconds = 10.0 if i < 8 else float(rng.uniform(2.0, 9.0))
        t = np.arange(int(sr * seconds)) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
        x += 0.05 * rng.standard_normal(t.shape[0])
        write_wav_int16(d / f"clip{i:02d}.wav", float_to_int16(x), sr)
        total += t.shape[0] / sr
    return total


def path_shape(model, lengths: list[int]) -> tuple[list[int], int]:
    """Frames of each clip's embedding and the device forwards that one
    ``embed_batch`` call over a dataset's clips (converted lengths in
    samples) makes, by family: whisper's 2 frames per 30 s window (16 windows
    to a forward), vggish's 0.96 s examples (256 to a forward), the speech
    bucketing, encodec-emb's groups of one exact length (64 to a forward,
    320-sample hop), encodec-emb-48k's full 1 s segments (150 frames each)
    and tail, dac-44kHz's 5 s windows at 50 % overlap (430 frames each, 8 to
    a forward)."""
    from collections import Counter

    from fadtk_tpu_torch.dsp.mel import vggish_num_examples
    from fadtk_tpu_torch.utils import next_multiple

    if model.name.startswith("whisper-"):
        return [2] * len(lengths), -(-len(lengths) // model.BATCH)
    if model.name == "vggish":
        examples = [vggish_num_examples(n) for n in lengths]
        return examples, -(-sum(examples) // model.EXAMPLE_BATCH)
    if model.name == "encodec-emb":
        groups = Counter(lengths).values()
        return ([-(-n // 320) for n in lengths],
                sum(-(-c // model.GROUP_BATCH) for c in groups))
    if model.name == "encodec-emb-48k":
        frames = [(n // 48000) * 150 + -(-(n % 48000) // 320) for n in lengths]
        return frames, sum((n >= 48000) + (n % 48000 > 0) for n in lengths)
    if model.name == "dac-44kHz":
        windows = [2 * max(1, -(-n // 220500)) - 1 for n in lengths]
        return [w * 430 for w in windows], -(-sum(windows) // model.WINDOW_BATCH)
    bucket = 10 * model.sr
    buckets = Counter(next_multiple(max(n, 1), bucket) for n in lengths).values()
    return ([model.cfg.num_output_frames(n) for n in lengths],
            sum(-(-c // model.MAX_BATCH) for c in buckets))


def cli_run(torch, kernels, work: Path, seconds: float, model_name: str, bf16: bool,
            env: dict | None = None) -> dict:
    """One CLI run over the two datasets with ``env`` set for the run only;
    checks the CSV row and the embedding caches. Returns the kernel launch
    counts (set to 0 just before the run, read just after it) and the number
    of device forwards the run made."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner import profiling

    model = get_model(model_name)
    key = model_name + ("-bf16" if bf16 else "")
    csv = work / f"scores-{key}.csv"
    reports: list[dict] = []
    real_report = profiling.report
    fa, fr, k3 = kernels

    def capture(reset: bool = True):
        reports.append(real_report(reset))
        return reports[-1]

    profiling.report = capture
    sys.argv = ["fadtk", model_name, str(work / "baseline"), str(work / "eval"), str(csv),
                *(["--bf16"] if bf16 else [])]
    os.environ.update(env or {})
    try:
        with rnn_warnings(f"[{key}]"):
            reset_counts(kernels)
            cli.main()
            torch.cuda.synchronize()
            launches = read_counts(kernels)
    finally:
        profiling.report = real_report
        os.environ.pop("FADTK_TPU_BF16", None)
        for k in env or {}:
            os.environ.pop(k)
    embed_s = sum(r.get("embed", 0.0) for r in reports)
    print(f"[{key}] {env or ''} profile per dataset: {reports}", flush=True)
    print(f"[{key}] embed stage: {seconds:.1f} audio-s in {embed_s:.3f} s = "
          f"{seconds / embed_s:.1f} audio-s/s; kernel launches {launches}", flush=True)

    rows = csv.read_text().strip().split("\n")
    print("\n".join(rows), flush=True)
    if rows[0] != "model,baseline,eval,score,inf_r2,time" or len(rows) != 2:
        raise AssertionError(f"unexpected CSV: {rows}")
    fields = rows[1].split(",")
    score = float(fields[3])
    if fields[0] != key or not math.isfinite(score):
        raise AssertionError(f"bad CSV row {rows[1]!r}")

    n_forwards = 0
    for ds in ("baseline", "eval"):
        embs = sorted((work / ds / "embeddings" / key).glob("*.npy"))
        if len(embs) != 16:
            raise AssertionError(f"{ds}/{key}: {len(embs)} embedding files")
        lengths = [read_wav_int16(work / ds / "convert" / str(model.sr) /
                                  f.with_suffix(".wav").name)[0].shape[0] for f in embs]
        frames, forwards = path_shape(model, lengths)
        n_forwards += forwards
        for f, n_frames in zip(embs, frames):
            e = np.load(f)
            want = (n_frames, model.num_features)
            if e.dtype != np.float16 or e.shape != want or not np.isfinite(e).all():
                raise AssertionError(f"{f}: {e.dtype} {e.shape}, expected float16 {want}")
        for stat in ("mu.npy", "cov.npy"):
            if not (work / ds / "stats" / key / stat).exists():
                raise AssertionError(f"{ds}/stats/{key}/{stat} missing")
    return {**launches, "forwards": n_forwards, "rate": seconds / embed_s, "score": score}


KERNEL_KEYS = ("K1", "K1b", "K4", "K4b", "K3", "K2", "K2g")


def reset_counts(kernels) -> None:
    """Every kernel launch count to 0."""
    fa, fr, k3 = kernels
    fa.flash_attention_packed.launches = fa.flash_attention_packed.bias_launches = 0
    fa.flash_attention.launches = fa.flash_attention.bias_launches = 0
    fa.flash_attention.grouped_launches = 0
    fr.fused_resnet_causal.launches = fr.fused_resnet_causal.bf16_launches = 0
    k3.fused_log_mel.launches = 0


def read_counts(kernels) -> dict:
    """The launch counts by kernel; K4 is the float32 SEANet block, K4b its
    bf16 tensor-core form; K2 is the per-head grid (with or without bias,
    ``flash_attention.py:490``), K2g the grouped one (:422)."""
    fa, fr, k3 = kernels
    return {"K1": fa.flash_attention_packed.launches,
            "K1b": fa.flash_attention_packed.bias_launches,
            "K4": fr.fused_resnet_causal.launches,
            "K4b": fr.fused_resnet_causal.bf16_launches,
            "K3": k3.fused_log_mel.launches,
            "K2": fa.flash_attention.launches + fa.flash_attention.bias_launches,
            "K2g": fa.flash_attention.grouped_launches}


def cli_runs(torch, kernels, work: Path) -> tuple[dict, dict, float]:
    """Every main path through the CLI, on two generated datasets. Returns
    the launches of each kernel summed over the runs that must launch it,
    each run's results by cache key, and the seconds of audio."""
    os.environ.pop("FADTK_TPU_BF16", None)
    os.environ.pop("FADTK_TPU_FLASH_F32", None)
    seconds = make_dataset(work, "baseline", SEED + 1) + make_dataset(work, "eval", SEED + 2)

    fused = {"FADTK_TPU_FUSED_RESNET": "1"}
    # (model, bf16, env for the run, kernel that must launch and how often
    # per device forward, or None)
    runs = [("w2v2-base", False, None, None), ("w2v2-base", True, None, ("K1", 12)),
            ("wavlm-base-plus", False, None, None), ("wavlm-base-plus", True, None, ("K1b", 12)),
            ("MERT-v1-95M", True, None, ("K1", 12)),
            ("encodec-emb", False, fused, ("K4", 4)), ("encodec-emb", True, fused, ("K4b", 4)),
            ("encodec-emb-48k", True, None, None), ("dac-44kHz", True, None, None),
            ("whisper-base", False, None, ("K3", 1)), ("whisper-base", True, None, ("K3", 1)),
            ("vggish", True, None, None)]
    totals = dict.fromkeys(KERNEL_KEYS, 0)
    cached = {}
    for model_name, bf16, env, kernel in runs:
        got = cli_run(torch, kernels, work, seconds, model_name, bf16, env)
        cached[model_name + ("-bf16" if bf16 else "")] = got
        want = dict.fromkeys(KERNEL_KEYS, 0)
        if kernel:
            want[kernel[0]] = kernel[1] * got["forwards"]
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{model_name} bf16={bf16}: launches {got}, expected {want} "
                                 f"({got['forwards']} device forwards)")
        for k in totals:
            totals[k] += got[k]
    return totals, cached, seconds


def pipeline_run(torch, kernels, work: Path, seconds: float, model_name: str, bf16: bool,
                 cached: dict, env: dict | None = None, argv: tuple = ()) -> dict:
    """One ``--device-pipeline`` CLI run over the two datasets, after the
    cached runs of ``cli_runs``. Checks the CSV row, that no embedding .npy
    was written, the frame count of each dataset against the clips, and in
    f32 the statistics and score against the cached path's. Returns the
    launch counts (set to 0 just before the run, read just after it), the
    device batches and checkpoint saves, and the pipeline's rate."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner import device_pipeline as pipe
    from fadtk_tpu_torch.runner import resume

    model = get_model(model_name)
    key = model_name + ("-bf16" if bf16 else "")
    csv = work / f"pipeline-{key}{'-'.join(argv)}.csv"
    stats, counts = {}, {"batches": 0, "saves": 0}
    real = (pipe.dataset_stats_device, pipe.merge_partial_stats_device, resume.StatsCheckpoint.save)

    def stats_device(model, files, **kw):
        t0 = time.perf_counter()
        out = real[0](model, files, **kw)
        stats[Path(files).name] = (*out, time.perf_counter() - t0)
        return out

    def merge(*a, **kw):
        counts["batches"] += 1
        return real[1](*a, **kw)

    def save(self, *a, **kw):
        counts["saves"] += 1
        return real[2](self, *a, **kw)

    def npys():
        return {(f, f.stat().st_mtime_ns) for f in work.glob("*/embeddings/*/*.npy")}

    before = npys()
    pipe.dataset_stats_device, pipe.merge_partial_stats_device = stats_device, merge
    resume.StatsCheckpoint.save = save
    sys.argv = ["fadtk", model_name, str(work / "baseline"), str(work / "eval"), str(csv),
                "--device-pipeline", *(["--bf16"] if bf16 else []), *argv]
    os.environ.update(env or {})
    try:
        reset_counts(kernels)
        cli.main()
        torch.cuda.synchronize()
        launches = read_counts(kernels)
    finally:
        pipe.dataset_stats_device, pipe.merge_partial_stats_device = real[:2]
        resume.StatsCheckpoint.save = real[2]
        os.environ.pop("FADTK_TPU_BF16", None)
        for k in env or {}:
            os.environ.pop(k)
    if npys() != before:
        raise AssertionError(f"[pipeline {key}] embedding .npy files were written")
    rows = csv.read_text().strip().split("\n")
    fields = rows[1].split(",") if len(rows) == 2 else []
    if rows[0] != "model,baseline,eval,score,inf_r2,time" or not fields or fields[0] != key:
        raise AssertionError(f"[pipeline {key}] unexpected CSV: {rows}")
    score = float(fields[3])
    pipe_s = sum(v[3] for v in stats.values())
    print(f"[pipeline {key} {' '.join(argv)}] {env or ''} {rows[1]}; {counts['batches']} device "
          f"batches, {counts['saves']} checkpoint saves; launches {launches}; "
          f"{seconds:.1f} audio-s in {pipe_s:.3f} s = {seconds / pipe_s:.1f} audio-s/s "
          f"(cached path's embed stage {cached[key]['rate']:.1f} audio-s/s)", flush=True)
    for ds in ("baseline", "eval"):
        mu, cov, n, _ = stats[ds]
        lengths = [read_wav_int16(f)[0].shape[0]
                   for f in sorted((work / ds / "convert" / str(model.sr)).glob("*.wav"))]
        if len(lengths) != 16 or n != sum(path_shape(model, lengths)[0]):
            raise AssertionError(f"[pipeline {key}] {ds}: {n} frames for {len(lengths)} clips")
        mu_c = np.load(work / ds / "stats" / key / "mu.npy")
        cov_c = np.load(work / ds / "stats" / key / "cov.npy")
        d_mu, d_cov = np.abs(mu - mu_c).max(), np.abs(cov - cov_c).max()
        if bf16:  # bounds relative to the cached path's largest value
            d_mu, d_cov = d_mu / np.abs(mu_c).max(), d_cov / np.abs(cov_c).max()
        lim = PIPE_TOL["bfloat16" if bf16 else "float32"]
        print(f"[pipeline {key}] {ds}: n={n}; vs cached stats mu {d_mu:.3e} ({lim['mu']:g}), "
              f"cov {d_cov:.3e} ({lim['cov']:g})" + (" of the largest value" if bf16 else ""),
              flush=True)
        if not (d_mu <= lim["mu"] and d_cov <= lim["cov"]):
            raise AssertionError(f"[pipeline {key}] {ds}: stats differ from the cached path")
    rel = abs(score - cached[key]["score"]) / abs(cached[key]["score"])
    print(f"[pipeline {key}] score {score} vs cached {cached[key]['score']}: relative "
          f"{rel:.3e} ({lim['score']:g})", flush=True)
    if not rel <= lim["score"]:
        raise AssertionError(f"[pipeline {key}] score differs from the cached path by {rel}")
    return {**launches, **counts, "rate": seconds / pipe_s}


def pipeline_runs(torch, kernels, work: Path, cached: dict, seconds: float) -> dict:
    """Every ``--device-pipeline`` run; returns the launches of each kernel
    summed over the runs that must launch it."""
    # (model, bf16, env, argv, kernel that must launch 12 times a device batch)
    runs = [("w2v2-base", False, None, (), None), ("w2v2-base", True, None, (), "K1"),
            ("wavlm-base-plus", False, None, (), None),
            ("wavlm-base-plus", True, None, (), "K2"),
            ("w2v2-base", False, {"FADTK_TPU_CKPT_FILES": "4"}, ("--batch", "4"), None)]
    totals = dict.fromkeys(KERNEL_KEYS, 0)
    for model_name, bf16, env, argv, kernel in runs:
        got = pipeline_run(torch, kernels, work, seconds, model_name, bf16, cached, env, argv)
        batches = 2 * (16 // (4 if argv else 16))  # two datasets of 16 clips
        want = dict.fromkeys(KERNEL_KEYS, 0)
        if kernel:
            want[kernel] = 12 * batches
        if {k: got[k] for k in want} != want or got["batches"] != batches:
            raise AssertionError(f"[pipeline {model_name} bf16={bf16}]: launches {got}, "
                                 f"expected {want} in {batches} device batches")
        if argv and got["saves"] < 2:
            raise AssertionError(f"[pipeline {model_name} {argv}]: {got['saves']} checkpoint saves")
        for k in totals:
            totals[k] += got[k]
    return totals


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (REPO / "fadtk_tpu_torch").is_dir():
        print(f"chip_smoke: no fadtk_tpu_torch package beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    started = time.perf_counter()
    try:
        phase("environment")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)

        phase("kernel build")
        from concurrent.futures import ThreadPoolExecutor

        from fadtk_tpu_torch.ops import flash_attention as fa
        from fadtk_tpu_torch.ops import fused_log_mel as k3
        from fadtk_tpu_torch.ops import fused_resnet as fr

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
            libs = list(pool.map(lambda m: m.library_path(), (fa, fr, k3)))
        print(f"built {', '.join(str(lib.relative_to(REPO)) for lib in libs)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for lib in libs:
            log = lib.with_suffix(".log")
            if log.exists():
                print(log.read_text().strip(), flush=True)

        phase("kernels vs plain twins")
        k1 = check_kernel(torch, fa, torch.bfloat16, 499, 12, bias=False)
        check_kernel(torch, fa, torch.float32, 499, 12, bias=False)
        check_kernel(torch, fa, torch.bfloat16, 749, 12, bias=False)
        k1b = check_kernel(torch, fa, torch.bfloat16, 499, 12, bias=True)
        check_kernel(torch, fa, torch.float32, 499, 12, bias=True)
        check_kernel(torch, fa, torch.bfloat16, 499, 16, bias=True)
        k2, k2g = k2_checks(torch, fa)
        k4 = k4_path_checks(torch, fr)
        k3_entry = k3_path_checks(torch, k3)
        torch.cuda.empty_cache()

        for model_name in ("w2v2-base", "wavlm-base-plus", "MERT-v1-95M"):
            phase(f"{model_name} f32: card vs cpu")
            m32, sr = card_vs_cpu(torch, model_name)
            phase(f"{model_name} forward: time and device time by kernel")
            forward_breakdown(torch, m32, model_name, sr)
            del m32
            torch.cuda.empty_cache()

        import numpy as np

        from fadtk_tpu_torch.models.dac_impl import dac_encode
        from fadtk_tpu_torch.models.encodec_impl import encodec_encode
        from fadtk_tpu_torch.models.vggish import vggish_forward

        work = Path(tempfile.mkdtemp(prefix="fadtk_tpu_torch_smoke_"))
        os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
        os.environ["FADTK_TPU_CHECKPOINTS"] = str(work / "checkpoints")
        os.environ.pop("FADTK_TPU_BF16", None)
        rng = np.random.default_rng(SEED)
        phase("encodec-emb f32: card vs cpu, fused block off and on")
        enc24 = model_card_vs_cpu(torch, "encodec-emb",
                                  (rng.standard_normal((1, 240000)) * 0.1).astype(np.float32),
                                  knobs=("0", "1"))
        phase("encodec-emb forward, batch 16 x 10 s: fused block off and on")
        module_forward_breakdown(torch, enc24, encodec_encode, (BATCH, 1, 240000), BATCH * 10.0,
                                "audio-s", knobs=("0", "1"), lstm_ab=True)
        del enc24
        phase("encodec-emb-48k f32: card vs cpu, 2.5 s stereo")
        model_card_vs_cpu(torch, "encodec-emb-48k",
                          (rng.standard_normal((2, 120000)) * 0.1).astype(np.float32))
        phase("dac-44kHz f32: card vs cpu, one 5 s window")
        dac = model_card_vs_cpu(torch, "dac-44kHz", rng.standard_normal(220500) * 0.1)
        phase("dac-44kHz forward, batch of 8 windows")
        module_forward_breakdown(torch, dac, dac_encode, (8, 1, 220500), 8 * 5.0, "window-s")
        del dac
        torch.cuda.empty_cache()

        phase("whisper-base f32: card vs cpu, one 30 s window")
        whisper = model_card_vs_cpu(torch, "whisper-base",
                                    rng.standard_normal(30 * SR) * 0.1)
        phase("vggish f32: card vs cpu, one 5 s clip")
        vgg = model_card_vs_cpu(torch, "vggish", rng.standard_normal(5 * SR) * 0.1)
        phase("vggish forward, one cross-file batch of 256 examples (frontend excluded)")
        module_forward_breakdown(torch, vgg, vggish_forward, (256, 96, 64), 256 * 0.96,
                                 "audio-s")
        del vgg
        phase("whisper-base forward, batch 16 x 30 s: f32 and bf16")
        whisper_forward_breakdown(torch, "base", whisper.module)
        del whisper
        phase("whisper-large forward, batch 16 x 30 s: f32 and bf16")
        whisper_forward_breakdown(torch, "large", runs=3)
        torch.cuda.empty_cache()

        phase("main paths: CLI w2v2-base, wavlm-base-plus, encodec-emb, whisper-base f32 and "
              "--bf16; MERT, encodec-emb-48k, dac-44kHz, vggish --bf16")
        launches, cached, seconds = cli_runs(torch, (fa, fr, k3), work)

        phase("device pipeline: CLI --device-pipeline w2v2-base, wavlm-base-plus f32 and --bf16, "
              "w2v2-base --batch 4 with checkpoints")
        pipeline = pipeline_runs(torch, (fa, fr, k3), work, cached, seconds)

        phase("device pipeline: the w2v2-base f32 gap to the cached path, split by source")
        sys.path.insert(0, str(REPO / "scripts"))
        from torch_pipeline_gap_probe import format_gap, split_gap

        from fadtk_tpu_torch.models.registry import get_model

        w2v2 = get_model("w2v2-base")
        for ds in ("baseline", "eval"):
            print(format_gap(f"w2v2-base f32 {ds}", split_gap(w2v2, work / ds)), flush=True)
        del w2v2

        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise AssertionError("jax was imported")
        print(f"\nsmoke phases passed in {time.perf_counter() - started:.1f} s", flush=True)
        source = "fadtk_tpu_torch/csrc/flash_attention_packed.cu"
        print(json.dumps({"kernels": [
            {"name": "flash_attention_packed", "route": "cuda", "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:703",
             "launches": launches["K1"], **k1},
            {"name": "flash_attention_packed (factorized bias)", "route": "cuda",
             "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:703 (bias term :559-562)",
             "launches": launches["K1b"], **k1b},
            {"name": "fused_resnet_causal (f32, one forward's four launches)", "route": "cuda",
             "source": "fadtk_tpu_torch/csrc/fused_resnet_causal.cu",
             "replaces": "fadtk_tpu/ops/fused_resnet.py:125",
             "launches": launches["K4"], **k4["float32"]},
            {"name": "fused_resnet_causal (bf16 tensor cores, one forward's four launches)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/fused_resnet_causal.cu",
             "replaces": "fadtk_tpu/ops/fused_resnet.py:125",
             "launches": launches["K4b"], **k4["bfloat16"]},
            {"name": "fused_log_mel (log10_clamp, Whisper B=16)", "route": "cuda",
             "source": "fadtk_tpu_torch/csrc/fused_log_mel.cu",
             "replaces": "fadtk_tpu/dsp/pallas_mel.py:86",
             "launches": launches["K3"], **k3_entry},
            {"name": "flash_attention (head-major, factorized bias)", "route": "cuda",
             "source": source, "replaces": "fadtk_tpu/ops/flash_attention.py:490",
             "launches": pipeline["K2"], **k2},
            {"name": "flash_attention (head-major, grouped grid)", "route": "cuda",
             "source": source, "replaces": "fadtk_tpu/ops/flash_attention.py:422",
             "launches": pipeline["K2g"], **k2g},
        ]}))
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
