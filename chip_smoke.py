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
     B=16/T=499/H=12 in bf16 and f32, MERT's 24 kHz bucket T=749 in bf16
     and f32, ragged n_valid (float32 runs as 3xTF32 on the tensor cores);
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
   - K3, the fused log-mel spectrogram, through the body its layout picks
     for the bases (printed beside each row): Whisper's geometry at B=16
     (3000 frames of 400 per 30 s window, read through the strided view of
     the reflect-padded signal, F=201, M=80) in ``log10_clamp`` on the
     folded FMA body (periodic-window bases, n_fft 400); ``ln_offset`` at
     VGGish's bases (W=400 in a 512-point DFT; F=257, M=64) on 256 x 96
     contiguous frames and ``db_clamp`` at CLAP's (W=1024, hop 480, F=513,
     M=64, 48 kHz) on B=16 x 1001 contiguous frames, both on the FFT body
     (windowed power-of-two DFTs); ``db_clamp`` on the strided view of the
     reflect-padded signal at the batch one CLAP forward takes (32 chunks):
     CLAP-LAION's 48 kHz / hop 480 / 1001 frames and MS-CLAP's 44.1 kHz /
     hop 320 / 965 frames (FFT body), and two of those chunks in the other
     two modes; the other two modes on Whisper's strided frames; an odd hop
     (321: the FFT body's one-float loads); ragged tiles (N = 1, 63, 65,
     130) through every body: Whisper's bases (folded), VGGish's and CLAP's
     (FFT) and random (1024, 513) bases (unfolded). The library yardstick is
     the chain torch.stft (periodic Hann) -> abs()² -> mel matmul ->
     clamp/log on the same signal; the bound counts the least work for the
     function (a real FFT of n_fft points, the split and power over the mel
     bands' bins, the mel matrix's nonzeros), with the GEMM formulation's
     bound (the folded DFT where the bases fold) printed beside;
   - K5, the float32 attention's bias and softmax in one pass in place over
     the logits: the 60 s bucket B=16/T=2999 and the 10 s bucket T=499,
     in WavLM-large's gated form (H=16, the (16, T, T) table) and in
     w2v2-base's key-mask form (H=12), ragged n_valid, against its twin,
     the torch composition it replaced (no single library call computes
     it), every row summing to 1 and every padded key exactly 0;
   - K6, the float32 projection as 3xTF32 on wgmma: Whisper-large's fc1,
     fc2 and q (B=16 windows, 24000 rows) and WavLM-large's and
     w2v2-base's FFN (the 60 s bucket, 47984 rows), its max and RMS error
     against a float64 product at most twice cuBLAS float32's (TF32 off),
     its time beside cuBLAS's sgemm (its twin on the card and the
     ``library_ms``) and the 3xTF32 bound; the main-path runs below then
     count its launches (``k6_per_forward``);
4. full-width forwards (random weights from a seed) of w2v2-base,
   wavlm-base-plus and MERT-v1-95M (24 kHz, T=749): f32 on the card against
   f32 on the CPU, same weights, one 10 s clip; for w2v2-base then one f32
   forward of that clip (T=499) with ``FADTK_TPU_FLASH_F32=1``, which must
   launch K1 in all 12 layers under ``FADTK_TPU_FLASH_F32_MIN_T=256`` and
   in none without it (the JAX package's routing); for MERT-v1-95M a
   batch-16 f32 forward of the 10 s bucket (T=749) with and without
   ``FADTK_TPU_FLASH_F32=1``, which must launch K1 12 times and 0 times and
   agree within ``RTOL_CARD_VS_CPU`` of the largest value, both timed (K1
   against plain PyTorch: wherever these phases say plain attention, its
   bias and softmax are the torch composition in K5's place); then
   batch-16 forward times for each (f32, f32 with plain attention, bf16,
   bf16 with plain attention) and the device time by kernel from
   torch.profiler;
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
   device time by kernel and the idle share; then Whisper's
   tensor-parallel step (``parallel/whisper_tp.py``, tp = 1) on
   whisper-large, B = 4 windows of 30 s of features, against the plain
   forward in f32 (1e-5 of the largest value) and bf16 (0.15), both timed;
7. the CLAP variants through their model classes, f32 on the card against
   f32 on the CPU, same weights, one 10 s clip (ten chunks): clap-laion-music
   (HTSAT-base, the widest published CLAP tower), clap-laion-audio and
   clap-2023; then a batch-32 forward of each (frontend included) in f32
   and bf16, with the device time by kernel, the idle share and K3's share;
   cdpam-acoustic and cdpam-content (16 convs, 512-d heads) f32 on the card
   against f32 on the CPU on one 5.3 s clip at 22.05 kHz (a ragged last
   chunk), then a batch of 128 chunks of 1 s in f32 and bf16 with the device
   time by kernel; then the port's weight converter without JAX:
   ``convert_cli --dry-run`` on every recorded schema (dac-44kHz,
   clap-laion-audio / -music .pt, clap-2023, cdpam, vggish), and dac-44kHz
   and clap-laion-music converted from checkpoints of seeded values,
   loaded by the models' ``load_model`` and run at full width on the card
   and the CPU (f32, 1e-3 of the largest value; the CLAP forward launches
   K3);
8. the main paths through the CLI (``fadtk_tpu_torch.cli.main.main``) on two
   generated datasets of 16 WAV clips each (full 10 s and ragged 2-9 s clips,
   some at 44.1 kHz so the host resampler runs): w2v2-base and
   wavlm-base-plus in f32 and ``--bf16``, MERT-v1-95M ``--bf16`` (resampled to
   24 kHz), encodec-emb in f32 and ``--bf16`` with the knob on,
   encodec-emb-48k, dac-44kHz, whisper-base, vggish, clap-laion-music,
   clap-2023 and cdpam-acoustic in f32 and ``--bf16``. Every kernel launch
   count is set to 0 just before each run and read just after it: K1/K1b
   (bf16) and K5 (f32) must launch 12 times per speech device batch, K4
   (f32) or K4b (its bf16 tensor-core form) 4 times per encodec-emb
   forward, K3 once per whisper (folded body) or CLAP forward (FFT body),
   and no kernel elsewhere;
9. the device pipeline through the CLI (``--device-pipeline``: no embedding
   caches, statistics on the card) on the same two datasets: w2v2-base and
   wavlm-base-plus in f32 and ``--bf16``, and w2v2-base f32 with ``--batch 4``
   and a checkpoint every 4 files. K1 must launch 12 times per device batch
   for w2v2-base bf16, K2 12 times per device batch for wavlm-base-plus
   bf16 (its tensor-parallel step at tp=1) and K5 12 times per device batch
   in every f32 run, no kernel elsewhere; the frame
   count must match the clips, the statistics the cached path's
   ``stats/<model>/`` and the score the cached path's, in f32 and bf16
   (``PIPE_TOL``); for w2v2-base f32 the gap is split into its sources
   (``scripts/torch_pipeline_gap_probe.py``); the pipeline's audio-s/s is
   printed beside the cached path's embed-stage rate. Then every other
   family through the chunked and whole-clip pipelines (``parallel/dp.py``):
   vggish, whisper-base (f32 and ``--bf16``), clap-laion-music, clap-2023,
   dac-44kHz, encodec-emb-48k (segments and exact-length tails), encodec-emb
   with the knob on (whole clips; f32 and ``--bf16``) and cdpam-acoustic,
   held to the same checks (the score against the FAD of the cached frames'
   float64 statistics, see ``pipeline_run``), K3 once per whisper or CLAP
   forward and K4 / K4b 4 times per encodec-emb forward, as predicted from
   the clip lengths (``pipeline_forwards``); then the device convert
   transport: the int16 clips of both datasets (copies without convert
   caches) converted on the card against the host convert (at most 1 LSB,
   at least 99.5% equal; before quantization within 1e-5, which a TF32
   product would miss), the device convert of the 44.1 kHz misses timed
   beside the host's, and ``--device-pipeline`` with
   ``FADTK_TPU_CONVERT_TRANSPORT=device`` on w2v2-base ``--bf16`` (K1) and
   whisper-base (K3) against the host transport on the same copies (the
   resample must run on the card; ``PIPE_TOL``); then ``--multihost``:
   ``python -m torch.distributed.run --nnodes 1 --nproc-per-node 1 -m
   fadtk_tpu_torch w2v2-base ... --device-pipeline --multihost``, whose
   score must equal the one-card run's within 1e-6 relative;
10. the scoring modes through the CLI on w2v2-base's f32 cache from phase 8:
   ``--inf``, ``--indiv``, ``--inf --device-scoring`` and ``--indiv
   --device-scoring`` (no kernel may launch). Every device per-song score
   lies within 2e-2 relative of the host float64 one; the device trace step,
   fed the host sweep's own subsamples, lies within 1e-3 of the host float64
   FAD of the same rows below n = d (the top n - 1 eigenvalues) and at
   n >= 4d (the JAX package's Newton-Schulz trace printed beside); then the
   host and device FAD-inf sweeps (25 steps) on a generated float16 frame
   matrix of 100 000 x 768, the device sweep twice (its points must be
   equal), and per-song host against device on 1 000 songs of 500 frames x
   768, through ``score_inf`` / ``score_individual``,
   timed beside the card's name and power limit; before the timings, the
   other module entry points: ``python -m fadtk_tpu_torch.test`` (the
   golden-score harness) on w2v2-base with a golden CSV made from this run's
   own scores, which must exit 0, and 2 once perturbed;
   ``python -m fadtk_tpu_torch.embeds`` over the 12 MERT-v1-95M variants on
   a fresh copy of the eval clips, one backbone forward per file, the
   default layer's caches against a per-variant run's;
   ``python -m fadtk_tpu_torch.package`` for w2v2-base and cdpam-acoustic,
   whose ``.npz`` must hold the stats caches; last,
   ``fadtk_tpu_torch.graft_entry``: ``entry()`` and
   ``dryrun_multichip(1)``'s seven paths on the card;
11. one JSON line of kernel results (launches also by path: K1 over the
   cached CLI runs and the device-transport runs, its float32 form over the
   cached f32 CLI runs (none: the knob is off) and the knob's forwards of
   phase 4; K3 and K4 over the cached
   CLI runs, the non-speech ``--device-pipeline`` runs and, for K3's
   Whisper form, the device-transport runs; K5 over the cached and the
   device-pipeline f32 speech runs), then
   ``{"ok": true, "device": ...}``.
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
# Chunks per CLAP forward (models/clap_laion.py, clap_ms.py: BATCH).
CLAP_BATCH = 32
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


def k2_checks(torch, fa) -> tuple[dict, dict, dict]:
    """K2 in every form at the main path's shapes; returns the kernels-line
    entries of the bf16 bias case at H=12, of the grouped case and of the
    float32 bias case."""
    bias = check_k2(torch, fa, torch.bfloat16, 12, "bias")
    check_k2(torch, fa, torch.bfloat16, 16, "bias")
    check_k2(torch, fa, torch.bfloat16, 6, "bias")
    bias_f32 = check_k2(torch, fa, torch.float32, 12, "bias")
    check_k2(torch, fa, torch.bfloat16, 12, "plain")
    grouped = check_k2(torch, fa, torch.bfloat16, 12, "grouped")
    strided = check_k2(torch, fa, torch.bfloat16, 12, "bias", strided=True)
    print(f"K2 bf16 bias H=12, contiguous / strided views: {bias['ms']:.4f} / "
          f"{strided['ms']:.4f} ms", flush=True)
    return bias, grouped, bias_f32


def check_attention_softmax(torch, asm, t: int, heads: int, gated: bool) -> dict:
    """K5 against its twin at (BATCH, heads, t, t) with the ragged n_valid of
    ``check_kernel``; with ``gated``, WavLM's gate (B, T, H) in [1, 3] and a
    random table (H, T, T) ~ N(0, 1). The twin's probabilities are computed
    first, a block of query rows at a time, then the kernel overwrites the
    logits: within 1e-6 of the twin, every row summing to 1 within 1e-6 (in
    float64), padded keys exactly 0. Times the kernel (in place, on the same
    logits) and the twin, the torch composition the kernel replaced; the
    bound counts the logits read and written once, the table, gate and key
    mask read once, and the bias and softmax arithmetic (3 + 5 operations an
    element gated, 1 + 5 with the key mask alone)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + t + heads)
    logits = torch.randn((BATCH, heads, t, t), generator=g, device=dev).mul_(3.0)
    nv_list = [min(n, t) for n in
               [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]]
    nv = torch.tensor(nv_list, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < nv[:, None]
    key_bias = ((1.0 - valid.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
    gate = table = None
    if gated:
        gate = torch.rand((BATCH, t, heads), generator=g, device=dev) * 2.0 + 1.0
        table = torch.randn((heads, t, t), generator=g, device=dev)
    label = f"K5 {'gated' if gated else 'key mask'} float32 B={BATCH} T={t} H={heads}"
    rows = 256
    want = torch.empty_like(logits)
    for i in range(0, t, rows):
        sl = slice(i, min(i + rows, t))
        want[:, :, sl] = asm.attention_softmax_reference(
            logits[:, :, sl], key_bias, None if gate is None else gate[:, sl],
            None if table is None else table[:, sl])
    plain_ms = cuda_ms(torch, lambda: asm.attention_softmax_reference(
        logits, key_bias, gate, table), runs=5)
    before = asm.attention_softmax.launches
    got = asm.attention_softmax(logits, key_bias, gate, table)
    torch.cuda.synchronize()
    if asm.attention_softmax.launches != before + 1 or got.data_ptr() != logits.data_ptr():
        raise AssertionError(f"{label}: not one launch in place")
    err = sum_err = 0.0
    for i in range(0, t, rows):
        block, ref = got[:, :, i:i + rows], want[:, :, i:i + rows]
        if not torch.isfinite(block).all():
            raise AssertionError(f"{label}: non-finite probabilities")
        sum_err = max(sum_err, (block.sum(-1, dtype=torch.float64) - 1).abs().max().item())
        err = max(err, (block - ref).abs().max().item())
    for b, n in enumerate(nv_list):
        if n < t and got[b, ..., n:].abs().max().item() != 0.0:
            raise AssertionError(f"{label} b={b}: a padded key's probability is not 0")
    del want
    ms = cuda_ms(torch, lambda: asm.attention_softmax(logits, key_bias, gate, table), runs=10)
    elements = logits.numel()
    nbytes = 4 * (2 * elements + key_bias.numel())
    if gated:
        nbytes += 4 * (table.numel() + gate.numel())
    bound = _roofline(elements * ((3 if gated else 1) + 5), nbytes, "float32")
    print(f"{label}: max_abs_err={err:.3e} (atol 1e-6), max |row sum - 1| {sum_err:.3e}; "
          f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms (the torch chain it replaced); "
          f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} ({nbytes / 1e9:.3f} GB), "
          f"{100 * bound['bound_ms'] / ms:.1f}% of it", flush=True)
    del logits, got, table
    torch.cuda.empty_cache()
    if not (err <= 1e-6 and sum_err <= 1e-6):
        raise AssertionError(f"{label}: kernel vs twin {err}, row sums off by {sum_err}")
    return {"max_abs_err": err, "row_sum_err": sum_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def k5_checks(torch, asm) -> dict:
    """K5 in both forms at the 60 s and the 10 s buckets; returns the
    kernels-line entries by form, the 10 s case under ``t499``."""
    return {form: {**check_attention_softmax(torch, asm, 2999, heads, gated),
                   "t499": check_attention_softmax(torch, asm, 499, heads, gated)}
            for form, heads, gated in (("gated", 16, True), ("key mask", 12, False))}


def check_linear_f32(torch, k6, label: str, m: int, k: int, n: int) -> dict:
    """K6 at x (m, k) . W (n, k)ᵀ + bias, W ~ U(±1/√k) as the models draw it,
    x ~ N(0, 1): its max and RMS error against a float64 product, relative to
    the largest |y|, beside cuBLAS float32's (TF32 off), each at most twice
    cuBLAS's; one launch. Times the kernel, its twin (``F.linear``, on the
    card the same cuBLAS sgemm, the port's path before K6, so it is also
    ``library_ms``), and the bound: 3 x 2mnk at the TF32 rate, against the
    bytes of x, W, its TF32 remainder, the bias and y."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + m + k + n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = (torch.rand((n, k), generator=g, device=dev) * 2 - 1) / k ** 0.5
    b = torch.randn((n,), generator=g, device=dev) * 0.1
    want = torch.nn.functional.linear(x.double(), w.double(), b.double())
    scale = want.abs().max().item()

    def errors(y):
        d = y.double() - want
        return d.abs().max().item() / scale, d.square().mean().sqrt().item() / scale

    before = k6.linear_f32.launches
    got = k6.linear_f32(x, w, b)
    torch.cuda.synchronize()
    if k6.linear_f32.launches != before + 1:
        raise AssertionError(f"K6 {label}: not one launch")
    err, lib_err = errors(got), errors(torch.nn.functional.linear(x, w, b))
    del want, got
    ms = cuda_ms(torch, lambda: k6.linear_f32(x, w, b), runs=10)
    library_ms = cuda_ms(torch, lambda: torch.nn.functional.linear(x, w, b), runs=10)
    flops = 2 * m * n * k
    bound = _roofline(flops, 4 * (m * k + 2 * n * k + n + m * n), "float32")
    print(f"K6 {label} M={m} K={k} N={n}: max_err {err[0]:.3e} rms {err[1]:.3e} (cuBLAS f32 "
          f"{lib_err[0]:.3e} / {lib_err[1]:.3e}); kernel={ms:.4f} ms twin=library={library_ms:.4f}"
          f" ms (x{library_ms / ms:.2f}); bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} (3xTF32), {100 * bound['bound_ms'] / ms:.1f}% of it; "
          f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    del x, w, b
    torch.cuda.empty_cache()
    if not (err[0] <= 2 * lib_err[0] and err[1] <= 2 * lib_err[1]):
        raise AssertionError(f"K6 {label}: error {err} against cuBLAS's {lib_err}")
    return {"max_err": err[0], "rms_err": err[1], "library_max_err": lib_err[0],
            "library_rms_err": lib_err[1], "ms": ms, "plain_ms": library_ms,
            "library_ms": library_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


def k6_checks(torch, k6) -> dict:
    """K6 at Whisper-large's fc1, fc2 and q (B=16 windows of 1500 frames) and
    WavLM-large's and w2v2-base's FFN (the 60 s bucket, 16 x 2999 frames)."""
    return {label: check_linear_f32(torch, k6, label, m, k, n) for label, m, k, n in (
        ("whisper-large fc1", 24000, 1280, 5120), ("whisper-large fc2", 24000, 5120, 1280),
        ("whisper-large q", 24000, 1280, 1280), ("wavlm-large intermediate", 47984, 1024, 4096),
        ("wavlm-large output", 47984, 4096, 1024), ("w2v2-base intermediate", 47984, 768, 3072),
        ("w2v2-base output", 47984, 3072, 768))}


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


def log_mel_bound(n: int, w: int, f: int, m: int, in_bytes: int, bins: int,
                  mel_nnz: int) -> dict:
    """The least time the card could take for one fused log-mel call over n
    frames, with the least work for the function: the window (W products),
    a real FFT of n_fft = 2 (F - 1) points as an n_fft/2-point complex FFT,
    5 (n_fft/2) log2(n_fft/2) FLOP, the split pass (16 FLOP a bin) and the
    power (3) over the ``bins`` rows the mel bands use, and the mel product
    over the mel matrix's nonzeros (2 nnz), per frame; against the frames'
    source read once (``in_bytes``: the padded signal for the strided view,
    the (N, W) frames otherwise), the window (n_fft floats), the twiddles
    (n_fft complex), the mel matrix read once and the (N, M) output
    written once, all float32."""
    p = f - 1
    flops = n * (w + 5 * p * math.log2(p) + 19 * bins + 2 * mel_nnz)
    nbytes = in_bytes + 4 * (2 * p + 4 * p + f * m) + 4 * n * m
    return {"flops": flops, "bytes": nbytes, **_roofline(flops, nbytes, "float32")}


def log_mel_gemm_bound(n: int, w: int, f: int, m: int, in_bytes: int, fold: bool,
                       mel_nnz: int) -> dict:
    """The same call's bound in the formulation of the Pallas kernel and the
    FMA bodies, the DFT as a product: 2·N·W·2F FLOP, or half that (2·N·F·W)
    where the bases fold (a periodic window with W = n_fft: ``dre[W-n] =
    dre[n]``, ``dim[W-n] = -dim[n]``), plus the mel product over the mel
    matrix's nonzeros (2·N·nnz), against the frames' source, the bases and
    the mel matrix read once and the (N, M) output written once."""
    flops = 2 * n * w * f * (1 if fold else 2) + 2 * n * mel_nnz
    nbytes = in_bytes + 4 * (2 * w * f + f * m) + 4 * n * m
    return {"flops": flops, "bytes": nbytes, **_roofline(flops, nbytes, "float32")}


def check_log_mel(torch, k3, label: str, frames, bases, log_mode: str, log_offset: float = 0.0,
                  in_bytes: int | None = None, library=None, body: str | None = None) -> dict:
    """K3 vs its twin on ``frames``, through the body the bases' layout
    names (``body``, when given, must be it); with ``library`` (the
    torch.stft chain on the frames' signal), also that chain's agreement,
    and the CUDA-event times of kernel, twin and chain beside the bound (the
    least work for the function: an FFT) and the GEMM formulation's."""
    layout = k3.kernel_layout(*bases)
    if body is not None and layout.body != body:
        raise AssertionError(f"{label}: the {layout.body} body serves these bases, not {body}")

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
    line = (f"{label} [{layout.body} body]: {tuple(out.shape)} max_abs_err={err:.3e} (atol "
            f"{tol:g}; max|twin| {ref.abs().max().item():.3f})")
    result = {"max_abs_err": err, "body": layout.body}
    if library is not None:
        lib_err = (library().reshape(ref.shape) - ref).abs().max().item()
        ms, plain_ms, library_ms = (cuda_ms(torch, fn) for fn in (kernel, twin, library))
        w, f, m = frames.shape[-1], bases[0].shape[1], bases[2].shape[1]
        n, nnz = ref.numel() // m, int((bases[2] != 0).sum())
        band = layout.band.long()
        bins = int((band[1].max() - band[0][band[0] < band[1]].min()).item())
        bound = log_mel_bound(n, w, f, m, in_bytes, bins, nnz)
        gemm = log_mel_gemm_bound(n, w, f, m, in_bytes, k3.bases_fold(*bases[:2]), nnz)
        result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                      bound_by=bound["bound_by"], library_ms=library_ms,
                      gemm_bound_ms=gemm["bound_ms"])
        line += (f"; stft chain vs twin {lib_err:.3e}; kernel={ms:.4f} ms plain={plain_ms:.4f} "
                 f"ms stft chain={library_ms:.4f} ms; bound (FFT) {bound['bound_ms'] * 1e3:.2f} "
                 f"us by {bound['bound_by']} ({bound['flops'] / 1e9:.3f} GFLOP, "
                 f"{bound['bytes'] / 1e6:.2f} MB); GEMM formulation "
                 f"{gemm['bound_ms'] * 1e3:.2f} us by {gemm['bound_by']} "
                 f"({gemm['flops'] / 1e9:.3f} GFLOP"
                 f"{cuda_core_note(gemm['flops'], gemm['bytes'], 'float32')})")
        if not lib_err <= 10 * tol:
            raise AssertionError(f"{label}: the stft chain differs from the twin by {lib_err}")
    print(line, flush=True)
    del out, ref
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs twin max_abs_err {err} > {tol}")
    return result


def k3_path_checks(torch, k3) -> dict:
    """K3 in its three modes and three bodies at the mel families'
    geometries, and ragged tiles. Returns the kernels-line entries of
    Whisper's B=16 call and of the two CLAP frontends' B=32 calls, by
    family."""
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
            stft_power(audio, 400, 160, 400, True)[..., :-1].transpose(1, 2) @ wb[2], 1e-10)),
        body="folded")

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
                      stft_power(padded, 512, 160, 400, False).T @ vb[2] + 0.01), body="fft")

    # CLAP's (laion, 48 kHz): 16 windows of 10 s, centred reflect framing.
    clap = torch.randn((BATCH, 480000), generator=g, device=dev) * 0.1
    frames = F.pad(clap[:, None], (512, 512), mode="reflect")[:, 0].unfold(-1, 1024, 480)
    frames = frames.contiguous().reshape(-1, 1024)
    cb = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    check_log_mel(torch, k3, f"K3 db_clamp CLAP bases N={frames.shape[0]}", frames, cb,
                  "db_clamp", in_bytes=4 * frames.numel(),
                  library=lambda: 10.0 * torch.log10(torch.clamp_min(
                      stft_power(clap, 1024, 480, 1024, True).transpose(1, 2) @ cb[2], 1e-10)),
                  body="fft")
    del audio, sig, frames, padded, clap

    # CLAP's frontends as the models call them: one forward's 32 chunks, the
    # frames read through the strided view of the reflect-padded signal; then
    # two chunks of each in the other two modes.
    clap_entries = {}
    for key, sr, seconds, hop in (("clap-laion", 48000, 10, 480), ("clap-2023", 44100, 7, 320)):
        chunks = torch.randn((CLAP_BATCH, sr * seconds), generator=g, device=dev) * 0.1
        cb = dmel._device_bases("torchlibrosa", dev, 1024, sr, 64, 50.0, 14000.0)
        frames = dmel.torchlibrosa_frames(chunks, 1024, hop)
        clap_entries[key] = check_log_mel(
            torch, k3, f"K3 db_clamp {key} B={CLAP_BATCH} x {frames.shape[1]} frames, hop {hop} "
            "(strided view)", frames, cb, "db_clamp",
            in_bytes=4 * CLAP_BATCH * (sr * seconds + 1024),
            library=lambda: 10.0 * torch.log10(torch.clamp_min(
                stft_power(chunks, 1024, hop, 1024, True).transpose(1, 2) @ cb[2], 1e-10)),
            body="fft")
        for mode, offset in (("ln_offset", 0.01), ("log10_clamp", 0.0)):
            check_log_mel(torch, k3, f"K3 {mode} {key} B=2 (strided view)", frames[:2], cb, mode,
                          offset, body="fft")
        del chunks, frames

    # The other two modes on Whisper's strided frames; an odd hop (the FFT
    # body's one-float loads); ragged frame tiles (three clips) through
    # every body: folded (Whisper's bases), FFT (VGGish's, n_fft 512, and
    # CLAP's, 1024) and unfolded (random (1024, 513) bases, no DFT).
    wf = dmel.whisper_frames(torch.randn((2, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1)
    for mode, offset in (("ln_offset", 0.01), ("db_clamp", 0.0)):
        check_log_mel(torch, k3, f"K3 {mode} Whisper B=2 (strided view)", wf, wb, mode, offset,
                      body="folded")
    cb = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    odd = dmel.torchlibrosa_frames(torch.randn((2, 321 * 64), generator=g, device=dev) * 0.1,
                                   1024, 321)
    check_log_mel(torch, k3, "K3 db_clamp CLAP bases, hop 321 (one-float loads)", odd, cb,
                  "db_clamp", body="fft")
    rb = (torch.randn((1024, 513), generator=g, device=dev) * 0.05,
          torch.randn((1024, 513), generator=g, device=dev) * 0.05,
          torch.rand((513, 64), generator=g, device=dev) * 0.01)
    for n in (1, 63, 65, 130):
        for case, bases, w, body in (("Whisper", wb, 400, "folded"), ("VGGish", vb, 400, "fft"),
                                     ("CLAP", cb, 1024, "fft"), ("random", rb, 1024, "unfolded")):
            check_log_mel(torch, k3, f"K3 log10_clamp ragged B=3 N={n} ({case} bases)",
                          torch.randn((3, n, w), generator=g, device=dev) * 0.1, bases,
                          "log10_clamp", body=body)
    return {"whisper": whisper, **clap_entries}


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


@contextlib.contextmanager
def plain_softmax():
    """The plain attention's bias and softmax as the torch composition
    (``attention_softmax_reference``) in K5's place, so that a kernel is
    held against, and a forward timed with, plain PyTorch."""
    from fadtk_tpu_torch.models.speech import encoder
    from fadtk_tpu_torch.ops import attention_softmax as asm

    encoder.attention_softmax = asm.attention_softmax_reference
    try:
        yield
    finally:
        encoder.attention_softmax = asm.attention_softmax


def flash_f32_min_t_check(torch, fa, m32) -> int:
    """w2v2-base f32 forwards of one 10 s clip (T=499) with
    ``FADTK_TPU_FLASH_F32=1``: under ``FADTK_TPU_FLASH_F32_MIN_T=256`` (the
    JAX package's f32 probe setting) every layer's attention takes K1 (12
    launches), without it (default 640) none, and the plain attention runs
    (``plain_softmax``); the two forwards agree within ``RTOL_CARD_VS_CPU``
    of the largest value (printed). Returns the K1 launches under the length
    knob."""
    from fadtk_tpu_torch.models.speech.encoder import speech_encoder_forward

    g = torch.Generator(device="cuda").manual_seed(SEED)
    audio = torch.randn((1, 160000), generator=g, device="cuda") * 0.1
    tap = m32.cfg.num_layers
    outs, launches = {}, {}
    os.environ["FADTK_TPU_FLASH_F32"] = "1"
    try:
        for min_t in ("256", None):
            if min_t is None:
                os.environ.pop("FADTK_TPU_FLASH_F32_MIN_T", None)
            else:
                os.environ["FADTK_TPU_FLASH_F32_MIN_T"] = min_t
            fa.flash_attention_packed.launches = 0
            with torch.inference_mode(), (plain_softmax() if min_t is None
                                          else contextlib.nullcontext()):
                outs[min_t], mask = speech_encoder_forward(m32, audio, taps=(tap,))
            torch.cuda.synchronize()
            launches[min_t] = fa.flash_attention_packed.launches
    finally:
        os.environ.pop("FADTK_TPU_FLASH_F32", None)
        os.environ.pop("FADTK_TPU_FLASH_F32_MIN_T", None)
    t = int(mask.sum())
    diff = (outs["256"] - outs[None]).abs().max().item()
    scale = outs[None].abs().max().item()
    print(f"w2v2-base f32 T={t}, FADTK_TPU_FLASH_F32=1: K1 launches {launches['256']} with "
          f"FADTK_TPU_FLASH_F32_MIN_T=256, {launches[None]} without; K1 vs plain attention "
          f"max_abs_diff={diff:.3e} ({diff / scale:.3e} of max {scale:.3e}; limit "
          f"{RTOL_CARD_VS_CPU:g})", flush=True)
    if t != 499 or launches != {"256": m32.cfg.num_layers, None: 0}:
        raise AssertionError(f"T={t}: K1 launches {launches}, expected 12 and 0")
    if not diff <= RTOL_CARD_VS_CPU * scale:
        raise AssertionError(f"K1 vs plain f32 forward: {diff / scale} > {RTOL_CARD_VS_CPU}")
    return launches["256"]


def bucket_batch(torch, sr: int):
    """A batch of the 10 s bucket at ``sr``: 8 full clips and 8 ragged ones
    (2-9 s), random from the seed; returns the audio, the valid sample counts
    and the seconds of valid audio."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = 10 * sr
    audio = torch.randn((BATCH, n), generator=g, device="cuda") * 0.1
    nv = torch.tensor([n] * 8 + [n * (i + 2) // 10 for i in range(8)], dtype=torch.int32,
                      device="cuda")
    return audio, nv, nv.sum().item() / sr


def mert_flash_f32_check(torch, fa, m32, sr: int) -> dict:
    """MERT-v1-95M f32 forwards of a batch of the 10 s bucket (T=749) with
    and without ``FADTK_TPU_FLASH_F32=1``: the knob sends every layer's
    attention to K1's float32 body (12 launches a forward, and no K5), its
    absence to the plain attention (0; ``plain_softmax``); the two agree
    within ``RTOL_CARD_VS_CPU`` of the largest value on valid frames. Both
    forwards are timed (CUDA events). Returns the launches and times."""
    from fadtk_tpu_torch.ops import attention_softmax as asm
    from fadtk_tpu_torch.models.speech.encoder import speech_encoder_forward

    audio, nv, audio_s = bucket_batch(torch, sr)
    tap = m32.cfg.num_layers
    outs, launches, ms = {}, {}, {}

    def forward():
        with torch.inference_mode():
            return speech_encoder_forward(m32, audio, nv, taps=(tap,))

    try:
        for knob in ("1", ""):
            os.environ["FADTK_TPU_FLASH_F32"] = knob
            fa.flash_attention_packed.launches = asm.attention_softmax.launches = 0
            with plain_softmax() if knob == "" else contextlib.nullcontext():
                outs[knob], mask = forward()
                torch.cuda.synchronize()
                launches[knob] = fa.flash_attention_packed.launches
                ms[knob] = cuda_ms(torch, forward, runs=10)
            if asm.attention_softmax.launches:
                raise AssertionError(f"FADTK_TPU_FLASH_F32={knob!r}: K5 launched "
                                     f"{asm.attention_softmax.launches} times")
    finally:
        os.environ.pop("FADTK_TPU_FLASH_F32", None)
    t = mask.shape[1]
    valid = mask[..., None].bool()
    diff = ((outs["1"] - outs[""]).abs() * valid).max().item()
    scale = (outs[""].abs() * valid).max().item()
    print(f"MERT-v1-95M f32 forward, B={BATCH} T={t} ({audio_s:.1f} s of valid audio): "
          f"FADTK_TPU_FLASH_F32=1 {ms['1']:.3f} ms, K1 launches {launches['1']}; plain "
          f"attention {ms['']:.3f} ms, K1 launches {launches['']}; max_abs_diff={diff:.3e} "
          f"({diff / scale:.3e} of max {scale:.3e}; limit {RTOL_CARD_VS_CPU:g})", flush=True)
    if t != 749 or launches != {"1": m32.cfg.num_layers, "": 0}:
        raise AssertionError(f"T={t}: K1 launches {launches}, expected 12 and 0")
    if not diff <= RTOL_CARD_VS_CPU * scale:
        raise AssertionError(f"MERT f32 with K1 vs plain: {diff / scale} > {RTOL_CARD_VS_CPU}")
    return {"launches": launches["1"], "ms_knob_on": ms["1"], "ms_knob_off": ms[""]}


def forward_breakdown(torch, m32, model_name: str, sr: int) -> None:
    """Batch-16 forwards of the 10 s bucket (8 full clips, 8 ragged): median
    CUDA-event time in f32 (K5), f32 with the plain attention
    (``plain_softmax``), bf16, and bf16 with the plain attention instead of
    the flash kernel; then device time by kernel from torch.profiler. Also
    warms up the libraries before the timed CLI runs."""
    import copy

    from fadtk_tpu_torch.models.speech.encoder import speech_encoder_forward

    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    audio, nv, audio_s = bucket_batch(torch, sr)
    tap = m32.cfg.num_layers

    def forward(model):
        with torch.inference_mode():
            return speech_encoder_forward(model, audio, nv, taps=(tap,))

    for name, model, flash in (("f32", m32, ""), ("f32 plain attention", m32, ""),
                               ("bf16", m16, ""), ("bf16 plain attention", m16, "0")):
        os.environ["FADTK_TPU_FLASH_ATTENTION"] = flash
        with plain_softmax() if "plain" in name else contextlib.nullcontext():
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


def whisper_forward_breakdown(torch, size: str, module=None, runs: int = 10):
    """Batch-16 forwards of 30 s windows, frontend (K3) included: median
    CUDA-event time in f32 and bf16, then one profiled forward each. Without
    ``module``, random weights drawn on the card from the seed (whisper-large
    has 1.55 B parameters). Returns the f32 module."""
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
    del m16
    return module


def clap_forward_breakdown(torch, model) -> None:
    """Batch-32 forwards of ``model``'s chunks (10 s at 48 kHz for
    clap-laion, 7 s at 44.1 kHz for clap-2023), the float32 frontend (one K3
    launch) included: median CUDA-event time in f32 and bf16, then one
    profiled forward each, and K3's share of the forward's time (K3 timed
    alone on the same frames, CUDA events both)."""
    import copy

    from fadtk_tpu_torch.models.base import cast_module
    from fadtk_tpu_torch.models.clap_laion import clap_laion_forward
    from fadtk_tpu_torch.models.clap_ms import clap_ms_forward

    from fadtk_tpu_torch.dsp import mel as dmel
    from fadtk_tpu_torch.ops.fused_log_mel import fused_log_mel

    if model.name == "clap-2023":
        def forward(module, x):
            return clap_ms_forward(module, model.mel, x)
        seconds, hop = 7, model.mel.hop
    else:
        forward, seconds, hop = clap_laion_forward, 10, 480
    m16 = cast_module(copy.deepcopy(model.module), torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    chunks = torch.randn((CLAP_BATCH, seconds * model.sr), generator=g, device="cuda") * 0.1
    frames = dmel.torchlibrosa_frames(chunks, 1024, hop)
    bases = dmel._device_bases("torchlibrosa", frames.device, 1024, model.sr, 64, 50.0, 14000.0)
    k3_ms = cuda_ms(torch, lambda: fused_log_mel(frames, *bases, log_mode="db_clamp"))

    def run(module):
        with torch.inference_mode():
            return forward(module, chunks)

    for name, module in (("f32", model.module), ("bf16", m16)):
        out = run(module)
        if out.shape != (CLAP_BATCH, model.num_features) or not torch.isfinite(out).all():
            raise AssertionError(f"{model.name} {name}: {tuple(out.shape)} or non-finite")
        ms = cuda_ms(torch, lambda: run(module), runs=10)
        print(f"{model.name} forward {name}: {ms:.3f} ms per batch of {CLAP_BATCH} x {seconds} s "
              f"= {CLAP_BATCH * seconds / ms * 1e3:.1f} chunk-s/s", flush=True)
        profile_forward(torch, f"{model.name} {name} B={CLAP_BATCH}", lambda: run(module))
        print(f"[{model.name} {name} B={CLAP_BATCH}] K3 (the frontend's one launch, timed alone "
              f"on the same frames) {k3_ms:.4f} ms = {k3_ms / ms:.3f} of the forward's time",
              flush=True)
    del m16, chunks, frames


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
    to a forward), CLAP's chunk per 1 s hop start (32 to a forward),
    vggish's 0.96 s examples (256 to a forward), the speech bucketing,
    encodec-emb's groups of one exact length (64 to a forward, 320-sample
    hop), encodec-emb-48k's full 1 s segments (150 frames each)
    and tail, dac-44kHz's 5 s windows at 50 % overlap (430 frames each, 8 to
    a forward), cdpam's 1 s chunks (128 to a forward)."""
    from collections import Counter

    from fadtk_tpu_torch.dsp.mel import vggish_num_examples
    from fadtk_tpu_torch.utils import next_multiple

    if model.name.startswith("whisper-"):
        return [2] * len(lengths), -(-len(lengths) // model.BATCH)
    if model.name.startswith("clap-"):
        chunks = [-(-n // model.sr) for n in lengths]  # one per 1 s hop start
        return chunks, -(-sum(chunks) // model.BATCH)
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
    if model.name.startswith("cdpam-"):
        chunks = [-(-n // model.sr) for n in lengths]
        return chunks, -(-sum(chunks) // model.CHUNK_BATCH)
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

    model = get_model(model_name)
    key = model_name + ("-bf16" if bf16 else "")
    csv = work / f"scores-{key}.csv"
    # The embed stage: host seconds inside the model's embed_batch, which
    # ends in a host copy of the embeddings and so waits for the device.
    cls = type(model)
    own_embed = cls.__dict__.get("embed_batch")
    real_embed = cls.embed_batch
    embed_calls: list[float] = []

    def timed_embed(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return real_embed(self, *a, **k)
        finally:
            embed_calls.append(time.perf_counter() - t0)

    cls.embed_batch = timed_embed
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
        if own_embed is None:
            del cls.embed_batch
        else:
            cls.embed_batch = own_embed
        os.environ.pop("FADTK_TPU_BF16", None)
        for k in env or {}:
            os.environ.pop(k)
    embed_s = sum(embed_calls)
    print(f"[{key}] {env or ''} embed_batch calls: {len(embed_calls)}", flush=True)
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


KERNEL_KEYS = ("K1", "K1b", "K4", "K4b", "K3", "K3f", "K2", "K2g", "K5", "K6")


def k6_per_forward(model_name: str, bf16: bool) -> int:
    """K6 launches in one float32 device forward of the main-path runs, whose
    batches all pass ``ops/linear_f32.py::MIN_ROWS`` (at least 4 clips of 499
    frames; a window's 1500 encoder states): a speech encoder's feature
    projection and six a layer (q, k, v, out and the FFN's two; WavLM's
    8-wide gate stays on cuBLAS); Whisper's six an encoder layer and two a
    decoder layer (the cross-attention's k and v over the encoder states; the
    decoder's 2-token rows stay on cuBLAS). None under bf16 or in the other
    families."""
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel

    model = get_model(model_name)
    if bf16:
        return 0
    if model_name.startswith("whisper-"):
        return 6 * model.cfg.encoder_layers + 2 * model.cfg.decoder_layers
    if isinstance(model, SpeechEmbeddingModel):
        return 1 + 6 * model.cfg.num_layers
    return 0


def reset_counts(kernels) -> None:
    """Every kernel launch count to 0."""
    fa, fr, k3, asm, k6 = kernels
    fa.flash_attention_packed.launches = fa.flash_attention_packed.bias_launches = 0
    fa.flash_attention.launches = fa.flash_attention.bias_launches = 0
    fa.flash_attention.grouped_launches = 0
    fr.fused_resnet_causal.launches = fr.fused_resnet_causal.bf16_launches = 0
    k3.fused_log_mel.launches = k3.fused_log_mel.fft_launches = 0
    asm.attention_softmax.launches = 0
    k6.linear_f32.launches = 0


def read_counts(kernels) -> dict:
    """The launch counts by kernel; K4 is the float32 SEANet block, K4b its
    bf16 tensor-core form; K2 is the per-head grid (with or without bias,
    ``flash_attention.py:490``), K2g the grouped one (:422); K5 the float32
    attention's bias and softmax, gated or with the key mask alone; K6 the
    float32 projection."""
    fa, fr, k3, asm, k6 = kernels
    return {"K1": fa.flash_attention_packed.launches,
            "K1b": fa.flash_attention_packed.bias_launches,
            "K4": fr.fused_resnet_causal.launches,
            "K4b": fr.fused_resnet_causal.bf16_launches,
            "K3": k3.fused_log_mel.launches,
            "K3f": k3.fused_log_mel.fft_launches,
            "K2": fa.flash_attention.launches + fa.flash_attention.bias_launches,
            "K2g": fa.flash_attention.grouped_launches,
            "K5": asm.attention_softmax.launches,
            "K6": k6.linear_f32.launches}


def cli_runs(torch, kernels, work: Path) -> tuple[dict, dict, float]:
    """Every main path through the CLI, on two generated datasets. Returns
    the launches of each kernel summed over the runs that must launch it (K3
    also by family: ``K3 whisper``, the folded body; ``K3 clap-laion``,
    ``K3 clap-2023``, the FFT body, ``K3f``), each run's results by cache
    key, and the seconds of audio."""
    os.environ.pop("FADTK_TPU_BF16", None)
    os.environ.pop("FADTK_TPU_FLASH_F32", None)
    seconds = make_dataset(work, "baseline", SEED + 1) + make_dataset(work, "eval", SEED + 2)

    fused = {"FADTK_TPU_FUSED_RESNET": "1"}
    # (model, bf16, env for the run, kernel that must launch and how often
    # per device forward, or None)
    runs = [("w2v2-base", False, None, ("K5", 12)), ("w2v2-base", True, None, ("K1", 12)),
            ("wavlm-base-plus", False, None, ("K5", 12)),
            ("wavlm-base-plus", True, None, ("K1b", 12)),
            ("MERT-v1-95M", True, None, ("K1", 12)),
            ("encodec-emb", False, fused, ("K4", 4)), ("encodec-emb", True, fused, ("K4b", 4)),
            ("encodec-emb-48k", False, None, None), ("encodec-emb-48k", True, None, None),
            ("dac-44kHz", False, None, None), ("dac-44kHz", True, None, None),
            ("whisper-base", False, None, ("K3", 1)), ("whisper-base", True, None, ("K3", 1)),
            ("vggish", False, None, None), ("vggish", True, None, None),
            ("clap-laion-music", False, None, ("K3f", 1)),
            ("clap-laion-music", True, None, ("K3f", 1)), ("clap-2023", False, None, ("K3f", 1)),
            ("clap-2023", True, None, ("K3f", 1)),
            ("cdpam-acoustic", False, None, None), ("cdpam-acoustic", True, None, None)]
    totals = dict.fromkeys((*KERNEL_KEYS, "K3 whisper", "K3 clap-laion", "K3 clap-2023"), 0)
    cached = {}
    for model_name, bf16, env, kernel in runs:
        got = cli_run(torch, kernels, work, seconds, model_name, bf16, env)
        cached[model_name + ("-bf16" if bf16 else "")] = got
        want = dict.fromkeys(KERNEL_KEYS, 0)
        want["K6"] = k6_per_forward(model_name, bf16) * got["forwards"]
        if kernel:
            want[kernel[0]] = kernel[1] * got["forwards"]
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{model_name} bf16={bf16}: launches {got}, expected {want} "
                                 f"({got['forwards']} device forwards)")
        for k in KERNEL_KEYS:
            totals[k] += got[k]
        family = next((f for f in ("whisper", "clap-laion", "clap-2023")
                       if model_name.startswith(f)), None)
        if family:
            totals[f"K3 {family}"] += got["K3" if family == "whisper" else "K3f"]
    return totals, cached, seconds


def exact_cached_score(work: Path, key: str) -> tuple[float, float]:
    """FAD between the two datasets from float64 statistics of all their
    cached float16 frames, without the float16 per-file means the cached
    path takes (as the reference does, ``np.mean`` of a float16 ``.npy``),
    and the sum of its terms before they cancel, tr C1 + tr C2 + |mu1 - mu2|²
    (the scale that float32 statistics' rounding moves the FAD by)."""
    import numpy as np

    from fadtk_tpu_torch.metric.frechet import frechet_distance

    stats = []
    for ds in ("baseline", "eval"):
        x = np.concatenate([np.load(f) for f in sorted((work / ds / "embeddings" / key)
                                                       .glob("*.npy"))]).astype(np.float64)
        stats += [x.mean(axis=0), np.cov(x, rowvar=False)]
    mu1, cov1, mu2, cov2 = stats
    scale = np.trace(cov1) + np.trace(cov2) + float(np.sum((mu1 - mu2) ** 2))
    return frechet_distance(*stats), float(scale)


def pipeline_run(torch, kernels, work: Path, seconds: float, model_name: str, bf16: bool,
                 cached: dict, env: dict | None = None, argv: tuple = (),
                 f16_means: bool = False) -> dict:
    """One ``--device-pipeline`` CLI run over the two datasets, after the
    cached runs of ``cli_runs``. Checks the CSV row, that no embedding .npy
    was written, the frame count of each dataset against the clips, and the
    statistics and score against the cached path's. With ``f16_means``
    (the non-speech families, whose FADs on these datasets are small beside
    the frames' scale), the score is held to the FAD of the cached frames'
    float64 statistics (``exact_cached_score``) within the tolerance times
    the sum of the FAD's terms before they cancel (float32 statistics are
    exact to a fraction of that sum, not of a small FAD), and to the cached
    path's score within that plus the cached score's own offset from the
    float64 one (the cached path's float16 per-file means). Returns the
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
    limit = lim["score"]
    if f16_means:
        exact, terms = exact_cached_score(work, key)
        gap = abs(score - exact)
        offset = abs(cached[key]["score"] - exact)
        print(f"[pipeline {key}] score {score} vs the FAD of the cached frames' float64 "
              f"statistics {exact}: {gap:.3e} = {gap / terms:.3e} of its terms' sum {terms:.4g} "
              f"({limit:g}; {gap / abs(exact):.3e} of the FAD); the cached path's float16-mean "
              f"offset from it {offset:.3e}", flush=True)
        if not gap <= limit * terms:
            raise AssertionError(f"[pipeline {key}] score differs from the float64 statistics' "
                                 f"by {gap}")
        limit = (limit * terms + offset) / abs(cached[key]["score"])
    print(f"[pipeline {key}] score {score} vs cached {cached[key]['score']}: relative "
          f"{rel:.3e} ({limit:g})", flush=True)
    if not rel <= limit:
        raise AssertionError(f"[pipeline {key}] score differs from the cached path by {rel}")
    return {**launches, **counts, "rate": seconds / pipe_s, "score": score}


def pipeline_runs(torch, kernels, work: Path, cached: dict, seconds: float) -> dict:
    """Every ``--device-pipeline`` run; returns the launches of each kernel
    summed over the runs that must launch it (K5 also in WavLM's gated form
    alone, ``K5 gated``)."""
    # (model, bf16, env, argv, kernel that must launch 12 times a device batch)
    runs = [("w2v2-base", False, None, (), "K5"), ("w2v2-base", True, None, (), "K1"),
            ("wavlm-base-plus", False, None, (), "K5"),
            ("wavlm-base-plus", True, None, (), "K2"),
            ("w2v2-base", False, {"FADTK_TPU_CKPT_FILES": "4"}, ("--batch", "4"), "K5")]
    totals = dict.fromkeys(KERNEL_KEYS, 0)
    for model_name, bf16, env, argv, kernel in runs:
        got = pipeline_run(torch, kernels, work, seconds, model_name, bf16, cached, env, argv)
        batches = 2 * (16 // (4 if argv else 16))  # two datasets of 16 clips
        want = dict.fromkeys(KERNEL_KEYS, 0)
        want["K6"] = k6_per_forward(model_name, bf16) * batches
        if kernel:
            want[kernel] = 12 * batches
        if {k: got[k] for k in want} != want or got["batches"] != batches:
            raise AssertionError(f"[pipeline {model_name} bf16={bf16}]: launches {got}, "
                                 f"expected {want} in {batches} device batches")
        if argv and got["saves"] < 2:
            raise AssertionError(f"[pipeline {model_name} {argv}]: {got['saves']} checkpoint saves")
        for k in KERNEL_KEYS:
            totals[k] += got[k]
        if (model_name, bf16, argv) == ("w2v2-base", False, ()):
            totals["score w2v2-base"] = got["score"]
        if (model_name, bf16) == ("wavlm-base-plus", False):
            totals["K2 f32"] = got["K2"]
            totals["K5 gated"] = got["K5"]
    return totals


def pipeline_forwards(model, lengths: list[int]) -> int:
    """Device forwards of one ``--device-pipeline`` pass (dp = 1) over a
    dataset's clips (converted lengths in samples), by family: the chunked
    path packs every clip's windows into batches of the family's preferred
    size (whisper one 30 s window a clip, 16 a batch; CLAP a chunk per 1 s
    hop start, 32; vggish's examples, 256; dac-44kHz's windows, 8;
    encodec-emb-48k's full 1 s segments, 64, its tails outside the batches;
    cdpam's 1 s chunks, 256); encodec-emb's whole-clip path dispatches each
    group of one length 8 clips at a time (16 clips never reach its
    early-flush cap of 32)."""
    from collections import Counter

    from fadtk_tpu_torch.dsp.mel import vggish_num_examples

    if model.name == "encodec-emb":
        return sum(-(-c // 8) for c in Counter(lengths).values())
    if model.name.startswith("whisper-"):
        rows, batch = len(lengths), 16
    elif model.name.startswith("clap-"):
        rows, batch = sum(-(-n // model.sr) for n in lengths), 32
    elif model.name == "vggish":
        rows, batch = sum(vggish_num_examples(n) for n in lengths), 256
    elif model.name == "dac-44kHz":
        rows, batch = sum(2 * max(1, -(-n // 220500)) - 1 for n in lengths), 8
    elif model.name == "encodec-emb-48k":
        rows, batch = sum(n // 48000 for n in lengths), 64
    elif model.name.startswith("cdpam-"):
        rows, batch = sum(-(-n // model.sr) for n in lengths), 256
    else:
        raise ValueError(model.name)
    return -(-rows // batch)


# The non-speech --device-pipeline runs: (model, bf16, env for the run, kernel
# that must launch and how often per device forward, or None).
DP_PIPELINE_RUNS = [
    ("vggish", False, None, None), ("whisper-base", False, None, ("K3", 1)),
    ("whisper-base", True, None, ("K3", 1)), ("clap-laion-music", False, None, ("K3f", 1)),
    ("clap-2023", False, None, ("K3f", 1)), ("dac-44kHz", False, None, None),
    ("encodec-emb-48k", False, None, None),
    ("encodec-emb", False, {"FADTK_TPU_FUSED_RESNET": "1"}, ("K4", 4)),
    ("encodec-emb", True, {"FADTK_TPU_FUSED_RESNET": "1"}, ("K4b", 4)),
    ("cdpam-acoustic", False, None, None),
]


def dp_pipeline_runs(torch, kernels, work: Path, cached: dict, seconds: float) -> dict:
    """``--device-pipeline`` for every non-speech family, through the chunked
    and whole-clip paths of ``parallel/dp.py``, against the cached runs of
    ``cli_runs`` (``pipeline_run``'s checks). K3 must launch once per device
    forward of whisper (the folded body) and CLAP (the FFT body, ``K3f``),
    K4 (f32) or K4b (bf16) four times per
    forward of encodec-emb with the knob on, as predicted from the clip
    lengths (``pipeline_forwards``), and nothing else. Returns the launches
    summed over the runs (K3 also by family)."""
    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.models.registry import get_model

    totals = dict.fromkeys((*KERNEL_KEYS, "K3 whisper", "K3 clap-laion", "K3 clap-2023"), 0)
    for model_name, bf16, env, kernel in DP_PIPELINE_RUNS:
        got = pipeline_run(torch, kernels, work, seconds, model_name, bf16, cached, env,
                           f16_means=True)
        model = get_model(model_name)
        forwards = 0
        for ds in ("baseline", "eval"):
            lengths = [read_wav_int16(f)[0].shape[0]
                       for f in sorted((work / ds / "convert" / str(model.sr)).glob("*.wav"))]
            forwards += pipeline_forwards(model, lengths)
        want = dict.fromkeys(KERNEL_KEYS, 0)
        want["K6"] = k6_per_forward(model_name, bf16) * forwards
        if kernel:
            want[kernel[0]] = kernel[1] * forwards
        print(f"[pipeline {model_name} bf16={bf16}] {forwards} device forwards predicted; "
              f"launches {want} predicted", flush=True)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"[pipeline {model_name} bf16={bf16}]: launches {got}, "
                                 f"expected {want} ({forwards} device forwards)")
        for k in KERNEL_KEYS:
            totals[k] += got[k]
        family = next((f for f in ("whisper", "clap-laion", "clap-2023")
                       if model_name.startswith(f)), None)
        if family:
            totals[f"K3 {family}"] += got["K3" if family == "whisper" else "K3f"]
    return totals


# --device-pipeline under the device convert transport: (model, bf16, the
# kernel that must launch and how often per device forward).
TRANSPORT_RUNS = [("w2v2-base", True, ("K1", 12)), ("whisper-base", False, ("K3", 1))]
# Device against host convert of the same clips: at most 1 int16 LSB apart,
# at least this share of samples equal (tests/test_torch_convert_transport.py).
TRANSPORT_MIN_EXACT = 0.995
TRANSPORT_PRE_QUANT_ATOL = 1e-5


def _copy_wavs(src: Path, dst: Path) -> None:
    """A dataset's clips without its convert/, embeddings/ and stats/ caches."""
    import shutil

    dst.mkdir(parents=True)
    for f in sorted(src.glob("*.wav")):
        shutil.copy2(f, dst / f.name)


def transport_run(torch, kernels, root: Path, model_name: str, bf16: bool,
                  transport: str) -> dict:
    """One ``--device-pipeline`` CLI run over ``root``'s two datasets (no
    convert caches: every clip a miss) under ``transport``. Returns each
    dataset's (mu, cov, n), the score, the launch counts (set to 0 just
    before the run, read just after it) and the run's seconds."""
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.runner import device_pipeline as pipe

    key = model_name + ("-bf16" if bf16 else "")
    csv = root / f"{key}-{transport}.csv"
    stats = {}
    real = pipe.dataset_stats_device

    def stats_device(model, files, **kw):
        out = real(model, files, **kw)
        stats[Path(files).name] = out
        return out

    env = {"FADTK_TPU_CONVERT_TRANSPORT": transport, "FADTK_TPU_CKPT": "0"}
    pipe.dataset_stats_device = stats_device
    sys.argv = ["fadtk", model_name, str(root / "baseline"), str(root / "eval"), str(csv),
                "--device-pipeline", *(["--bf16"] if bf16 else [])]
    os.environ.update(env)
    try:
        reset_counts(kernels)
        t0 = time.perf_counter()
        cli.main()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts(kernels)
    finally:
        pipe.dataset_stats_device = real
        os.environ.pop("FADTK_TPU_BF16", None)
        for k in env:
            os.environ.pop(k)
    for ds in ("baseline", "eval"):
        if any((root / ds / sub).exists() for sub in ("convert", "embeddings")):
            raise AssertionError(f"[transport {key} {transport}] {ds}: a cache was written")
    fields = csv.read_text().strip().split("\n")[1].split(",")
    return {"stats": stats, "score": float(fields[3]), "launches": launches, "s": run_s}


def transport_clip_check(torch, work: Path) -> None:
    """The int16 clips of both datasets at 16 kHz (copies without their
    convert caches, so every clip is a miss), device convert against the
    host's (the cache writer's ``convert_audio``), and the time of the
    device convert of the 44.1 kHz misses beside the host convert's."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import float_to_int16
    from fadtk_tpu_torch.dsp.resample import resample_batch, resample_kaiser
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner import convert
    from fadtk_tpu_torch.runner.fad import convert_audio

    model = get_model("w2v2-base")  # only its rate (16 kHz) is used
    loader = convert.ClipLoader(model, workers=8, transport="device")
    if loader.device.type != "cuda":
        raise AssertionError(f"device transport on {loader.device}")
    root = work / "transport" / "clips"
    for ds in ("baseline", "eval"):
        _copy_wavs(work / ds, root / ds)
    files = [f for ds in ("baseline", "eval") for f in sorted((root / ds).glob("*.wav"))]
    probed = [loader._probe(f) for f in files]
    misses = [(convert._Miss(i, mono, q), sr) for i, (kind, mono, q, sr) in enumerate(probed)
              if kind == "miss"]
    if len(misses) != len(files):
        raise AssertionError("the copies must have no convert cache")
    got = loader._convert_misses(misses)
    equal = total = worst = 0
    for i, f in enumerate(files):
        want = convert_audio(f, model.sr).astype(np.int64)
        d = np.abs(got[i].astype(np.int64) - want) if got[i].shape == want.shape else None
        if d is None:
            raise AssertionError(f"{f.name}: {got[i].shape} vs host {want.shape}")
        equal, total, worst = equal + int((d == 0).sum()), total + d.size, max(worst, int(d.max()))
    print(f"[transport] {len(files)} clips device vs host convert: {equal / total:.6f} of "
          f"{total} samples equal, max |diff| {worst} LSB (limits {TRANSPORT_MIN_EXACT}, 1)",
          flush=True)
    if worst > 1 or equal / total < TRANSPORT_MIN_EXACT:
        raise AssertionError("device convert differs from the host convert")

    slow = [(m, sr) for m, sr in misses if sr == 44100]
    monos = [m.mono for m, _ in slow]
    # The product before quantization: float32 sums in another order than
    # the host's BLAS (~1e-6); a TF32 product would be ~1e-3 off.
    pre = max(float(np.abs(resample_batch(torch.from_numpy(x[None]).cuda(), 44100, model.sr)[0]
                           .cpu().numpy() - resample_kaiser(x, 44100, model.sr)).max())
              for x in monos)
    print(f"[transport] the 44.1 kHz clips' resample on the card before quantization: max "
          f"|card - host| {pre:.3e} (limit {TRANSPORT_PRE_QUANT_ATOL:g})", flush=True)
    if not pre <= TRANSPORT_PRE_QUANT_ATOL:
        raise AssertionError("the card's resample is not float32-accurate")

    def host():
        return [float_to_int16(resample_kaiser(x, 44100, model.sr)) for x in monos]

    def device():
        return loader._convert_misses(slow)

    times = {}
    for name, fn in (("host", host), ("device", device)):
        fn()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        times[name] = statistics.median(runs)
    audio_s = sum(x.shape[0] for x in monos) / 44100
    print(f"[transport] convert of the {len(monos)} 44.1 kHz misses ({audio_s:.1f} audio-s, "
          f"int16 shipped): device {times['device'] * 1e3:.2f} ms (upload, resample, quantize, "
          f"download) = {audio_s / times['device']:.1f} audio-s/s; host (one thread) "
          f"{times['host'] * 1e3:.2f} ms = {audio_s / times['host']:.1f} audio-s/s", flush=True)


def transport_runs(torch, kernels, work: Path) -> dict:
    """``--device-pipeline`` with the device convert transport against the
    host transport on copies of the two datasets without their convert
    caches: the resample must run on the card (and not at all under host),
    the statistics and score agree within ``PIPE_TOL``, and the kernels
    launch as predicted. Returns the device-transport runs' launches."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.dsp import resample
    from fadtk_tpu_torch.models.registry import get_model

    transport_clip_check(torch, work)
    devices: list[str] = []
    real = resample.convert_device

    def recorded(x, sr_in, sr_out):
        devices.append(x.device.type)
        return real(x, sr_in, sr_out)

    totals = dict.fromkeys(KERNEL_KEYS, 0)
    resample.convert_device = recorded
    try:
        for model_name, bf16, kernel in TRANSPORT_RUNS:
            key = model_name + ("-bf16" if bf16 else "")
            got = {}
            for transport in ("host", "device"):
                root = work / "transport" / f"{key}-{transport}"
                for ds in ("baseline", "eval"):
                    _copy_wavs(work / ds, root / ds)
                devices.clear()
                got[transport] = transport_run(torch, kernels, root, model_name, bf16, transport)
                where = sorted(set(devices))
                print(f"[transport {key} {transport}] score {got[transport]['score']}; "
                      f"{len(devices)} resample batches on {where}; run "
                      f"{got[transport]['s']:.2f} s; launches {got[transport]['launches']}",
                      flush=True)
                if (transport == "device") != (where == ["cuda"]):
                    raise AssertionError(f"[transport {key} {transport}] resampled on {where}")
            model = get_model(model_name)
            forwards = 0
            for ds in ("baseline", "eval"):
                lengths = [read_wav_int16(f)[0].shape[0] for f in
                           sorted((work / ds / "convert" / str(model.sr)).glob("*.wav"))]
                # The speech step takes the default batch of 16 clips.
                forwards += (-(-len(lengths) // 16) if kernel[0] == "K1"
                             else pipeline_forwards(model, lengths))
            want = dict.fromkeys(KERNEL_KEYS, 0)
            want["K6"] = k6_per_forward(model_name, bf16) * forwards
            want[kernel[0]] = kernel[1] * forwards
            launches = got["device"]["launches"]
            if {k: launches[k] for k in want} != want:
                raise AssertionError(f"[transport {key} device]: launches {launches}, "
                                     f"expected {want}")
            lim = PIPE_TOL["bfloat16" if bf16 else "float32"]
            for ds in ("baseline", "eval"):
                (mu, cov, n), (mu_h, cov_h, n_h) = (got["device"]["stats"][ds],
                                                   got["host"]["stats"][ds])
                d_mu, d_cov = np.abs(mu - mu_h).max(), np.abs(cov - cov_h).max()
                if bf16:
                    d_mu, d_cov = d_mu / np.abs(mu_h).max(), d_cov / np.abs(cov_h).max()
                print(f"[transport {key}] {ds}: n={n}; device vs host transport mu {d_mu:.3e} "
                      f"({lim['mu']:g}), cov {d_cov:.3e} ({lim['cov']:g})"
                      + (" of the largest value" if bf16 else ""), flush=True)
                if n != n_h or not (d_mu <= lim["mu"] and d_cov <= lim["cov"]):
                    raise AssertionError(f"[transport {key}] {ds}: stats differ")
            s_d, s_h = got["device"]["score"], got["host"]["score"]
            rel = abs(s_d - s_h) / abs(s_h)
            print(f"[transport {key}] score device {s_d} vs host {s_h}: relative {rel:.3e} "
                  f"({lim['score']:g})", flush=True)
            if not rel <= lim["score"]:
                raise AssertionError(f"[transport {key}] score differs by {rel}")
            for k in KERNEL_KEYS:
                totals[k] += launches[k]
    finally:
        resample.convert_device = real
    return totals


# --multihost under torch.distributed.run against the plain one-card run.
MULTIHOST_RTOL = 1e-6


def multihost_check(work: Path, plain_score: float) -> None:
    """``python -m torch.distributed.run --nnodes 1 --nproc-per-node 1 -m
    fadtk_tpu_torch w2v2-base ... --device-pipeline --multihost`` on the two
    datasets: the score must equal the in-process ``--device-pipeline``
    run's (phase 9)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    csv = work / "multihost.csv"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for k in ("FADTK_TPU_BF16", "FADTK_TPU_CONVERT_TRANSPORT", "FADTK_TPU_TORCH_DEVICE"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
           "1", "--master-addr", "127.0.0.1", "--master-port", str(port), "-m",
           "fadtk_tpu_torch", "w2v2-base", str(work / "baseline"), str(work / "eval"),
           str(csv), "--device-pipeline", "--multihost"]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    print("\n".join((p.stdout + p.stderr).strip().splitlines()[-6:]), flush=True)
    if p.returncode != 0:
        raise AssertionError(f"--multihost exited {p.returncode}: {p.stderr[-3000:]}")
    score = float(csv.read_text().strip().split("\n")[1].split(",")[3])
    rel = abs(score - plain_score) / abs(plain_score)
    print(f"[multihost] score {score} vs the one-card run {plain_score}: relative {rel:.3e} "
          f"({MULTIHOST_RTOL:g}); {time.perf_counter() - t0:.1f} s with the launch", flush=True)
    if not rel <= MULTIHOST_RTOL:
        raise AssertionError(f"--multihost score differs by {rel}")


# Whisper's tp step at tp = 1 against the plain forward, of the largest value.
WHISPER_TP_TOL = {"float32": 1e-5, "bfloat16": 0.15}


def whisper_tp_check(torch, module, label: str) -> None:
    """``parallel/whisper_tp.py``'s step at tp = 1 on a full-width module
    (``label``: whisper-large in the smoke) against ``whisper_forward``,
    B = 4 windows of 30 s of log-mel features, f32 and bf16, both timed."""
    import copy

    from fadtk_tpu_torch.dsp.mel import WHISPER_SAMPLES, whisper_log_mel
    from fadtk_tpu_torch.models import whisper_impl as wi
    from fadtk_tpu_torch.parallel.mesh import make_mesh
    from fadtk_tpu_torch.parallel.whisper_tp import (
        make_sharded_whisper_step,
        shard_whisper_params,
    )

    mesh = make_mesh()
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    with torch.inference_mode():
        feats = whisper_log_mel(torch.randn((4, WHISPER_SAMPLES), generator=g,
                                            device="cuda") * 0.1)
    for name, m in (("float32", module), ("bfloat16", copy.deepcopy(module).to(torch.bfloat16))):
        step = make_sharded_whisper_step(m.cfg, mesh)
        shard = shard_whisper_params(m, mesh)
        with torch.inference_mode():
            got = step(shard, feats)
            want = wi.whisper_forward(m, feats)
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        tp_ms = cuda_ms(torch, lambda: step(shard, feats), runs=3, groups=3)

        def plain():
            with torch.inference_mode():
                return wi.whisper_forward(m, feats)

        plain_ms = cuda_ms(torch, plain, runs=3, groups=3)
        print(f"[whisper tp] {label} {name} B=4 tp=1: {tuple(got.shape)}, "
              f"max_abs_diff {diff:.3e} of max {scale:.3e} = {diff / scale:.3e} "
              f"(limit {WHISPER_TP_TOL[name]:g}); step {tp_ms:.3f} ms, plain forward "
              f"{plain_ms:.3f} ms", flush=True)
        if got.shape != (4, 2, m.cfg.d_model) or not diff <= WHISPER_TP_TOL[name] * scale:
            raise AssertionError(f"whisper tp {name} differs from the plain forward")
        del m, shard


def _filled(schema: dict, seed: int) -> dict:
    """A state dict of the schema's shapes with seeded values: running
    variances, snake alphas and weight-norm gains positive."""
    import numpy as np

    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in schema.items():
        if k.endswith(("running_var", ".alpha", "weight_g")):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.standard_normal(shape) * 0.05
        out[k] = torch.from_numpy(np.asarray(x, np.float32))
    return out


def convert_checks(torch, kernels, work: Path) -> None:
    """The port's converter without JAX: ``convert_cli --dry-run`` on every
    recorded schema; then the dac-44kHz and clap-laion-music schemas filled
    with seeded values, converted with ``convert_cli --checkpoint``, loaded
    through ``FADTK_TPU_CHECKPOINTS`` by the models' own ``load_model`` and
    run at full width on the card and the CPU (``model_card_vs_cpu``); the
    CLAP forward launches K3's FFT body."""
    import json as _json

    import numpy as np

    from fadtk_tpu_torch.weights import convert_cli, schemas

    root = work / "convert"
    root.mkdir()
    recorded = {"dac-44kHz": schemas.dac_44khz_encoder_schema(),
                "clap-laion-audio": schemas.laion_clap_pt_schema("HTSAT-tiny"),
                "clap-laion-music": schemas.laion_clap_pt_schema("HTSAT-base"),
                "clap-2023": schemas.msclap_2023_audio_schema(),
                "cdpam-acoustic": schemas.cdpam_base_encoder_schema(),
                "vggish": schemas.vggish_schema()}
    argv = sys.argv
    saved = {k: os.environ.get(k) for k in ("FADTK_TPU_CHECKPOINTS", "FADTK_TPU_RANDOM_WEIGHTS")}
    try:
        for name, schema in recorded.items():
            path = root / f"{name}.json"
            path.write_text(_json.dumps({k: list(v) for k, v in schema.items()}))
            sys.argv = ["convert_cli", name, "--dry-run", str(path)]
            convert_cli.main()
            print(f"[convert] --dry-run {name}: {len(schema)} keys OK", flush=True)
        if any(m == "jax" or m.startswith(("jax.", "fadtk_tpu.")) for m in sys.modules):
            raise AssertionError("the converter imported jax or the JAX package")

        os.environ["FADTK_TPU_CHECKPOINTS"] = str(root / "checkpoints")
        os.environ.pop("FADTK_TPU_RANDOM_WEIGHTS", None)
        rng = np.random.default_rng(SEED)
        for name, ck, seconds, sr, check in (
            ("dac-44kHz", "weights_44khz.pth", 5, 44100, "encoder.block.6.bias"),
            ("clap-laion-music", "music_audioset_epoch_15_esc_90.14.pt", 10, 48000,
             "module.audio_projection.2.bias"),
        ):
            sd = _filled(recorded[name], SEED + len(name))
            torch.save({"state_dict": sd}, root / ck)
            t0 = time.perf_counter()
            sys.argv = ["convert_cli", name, "--checkpoint", str(root / ck)]
            convert_cli.main()
            print(f"[convert] {name}: {ck} -> {sorted(p.name for p in (root / 'checkpoints').glob('*.npz'))} "
                  f"in {time.perf_counter() - t0:.1f} s", flush=True)
            reset_counts(kernels)
            model = model_card_vs_cpu(torch, name, rng.standard_normal(seconds * sr) * 0.1)
            k3 = read_counts(kernels)["K3f"]
            loaded = (model.module.conv_out.bias if name == "dac-44kHz"
                      else model.module.audio_projection.linear2.bias)
            if not torch.equal(loaded.cpu(), sd[check]):
                raise AssertionError(f"{name}: the model did not load the converted weights")
            print(f"[convert] {name}: the converted .npz loaded on the card and the CPU; "
                  f"K3's FFT body launches {k3}", flush=True)
            if (k3 > 0) != name.startswith("clap"):
                raise AssertionError(f"{name}: K3's FFT body launched {k3} times")
            del model
    finally:
        sys.argv = argv
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def graft_twin_check(torch) -> None:
    """``fadtk_tpu_torch.graft_entry``: ``entry()``'s forward on the card and
    ``dryrun_multichip(1)``'s seven paths."""
    from fadtk_tpu_torch import graft_entry

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    with torch.inference_mode():
        hidden, mask = fn(*args)
    torch.cuda.synchronize()
    if hidden.shape[:2] != (13, 2) or not torch.isfinite(hidden).all():
        raise AssertionError(f"entry(): {tuple(hidden.shape)} or non-finite")
    print(f"[graft] entry(): hidden {tuple(hidden.shape)}, mask {tuple(mask.shape)} on "
          f"{hidden.device}", flush=True)
    graft_entry.dryrun_multichip(1)
    print(f"[graft] dryrun_multichip(1): seven paths on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# Device scoring against the host float64 paths (metric/device_scoring.py):
# per-song scores within the JAX package's own bound
# (tests/test_device_scoring.py), near-zero scores guarded at 1e-6; the
# trace step on the host's own subsample within the float32 path's ~1e-3.
PER_SONG_RTOL = 2e-2
TRACE_STEP_RTOL = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-6)


def _per_song_gap(host_csv: Path, device_csv: Path) -> tuple[float, int]:
    """The largest relative gap of the device per-song scores to the host
    ones, over every song of the two CSVs (which must list the same files)."""
    host = dict(row.split(",") for row in host_csv.read_text().split("\n"))
    dev = dict(row.split(",") for row in device_csv.read_text().split("\n"))
    if set(host) != set(dev) or not host:
        raise AssertionError(f"per-song CSVs list other files: {len(host)} / {len(dev)}")
    return max(_rel(float(dev[f]), float(h)) for f, h in host.items()), len(host)


def scoring_cli(torch, kernels, work: Path, *flags) -> tuple[Path, float]:
    """One w2v2-base scoring run of the CLI over the two datasets' cached f32
    embeddings (none is computed again); no kernel may launch. Returns the
    CSV and the run's seconds."""
    from fadtk_tpu_torch.cli import main as cli

    csv = work / f"scoring{'-'.join(flags)}.csv"
    sys.argv = ["fadtk", "w2v2-base", str(work / "baseline"), str(work / "eval"), str(csv),
                *flags]
    reset_counts(kernels)
    t0 = time.perf_counter()
    try:
        cli.main()
    except SystemExit as e:  # --indiv exits 0 after writing its CSV
        if e.code not in (0, None):
            raise AssertionError(f"scoring {flags}: exit {e.code}") from e
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(kernels)
    if any(launches.values()) or not csv.exists():
        raise AssertionError(f"scoring {flags}: launches {launches}, CSV written {csv.exists()}")
    print(f"[scoring {' '.join(flags)}] {secs:.3f} s", flush=True)
    return csv, secs


def scoring_checks(torch, kernels, work: Path) -> None:
    """``--inf`` and ``--indiv``, on the host and with ``--device-scoring``,
    through the CLI on w2v2-base's f32 cache; the device per-song scores
    against the host's, and the device trace step on the host sweep's own
    subsamples in both of its branches."""
    import numpy as np

    from fadtk_tpu_torch.metric import device_scoring as ds
    from fadtk_tpu_torch.metric.frechet import FrechetBaseline, _ns_sqrt_sym
    from fadtk_tpu_torch.metric.stats import (
        calc_embd_statistics,
        welford_finalize,
        welford_init,
        welford_update,
    )
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    runs = {flags: scoring_cli(torch, kernels, work, *flags)
            for flags in (("--inf",), ("--inf", "--device-scoring"), ("--indiv",),
                          ("--indiv", "--device-scoring"))}
    for flags in (("--inf",), ("--inf", "--device-scoring")):
        row = runs[flags][0].read_text().strip().split("\n")[1].split(",")
        score, r2 = float(row[3]), float(row[4])
        print(f"[scoring {' '.join(flags)}] FAD-inf {score}, r2 {r2}", flush=True)
        if not (math.isfinite(score) and math.isfinite(r2)) or row[0] != "w2v2-base":
            raise AssertionError(f"scoring {flags}: bad CSV row {row}")
    gap, n = _per_song_gap(runs[("--indiv",)][0], runs[("--indiv", "--device-scoring")][0])
    print(f"[scoring --indiv] device vs host float64 per-song, {n} songs: largest relative gap "
          f"{gap:.3e} (limit {PER_SONG_RTOL:g})", flush=True)
    if not gap <= PER_SONG_RTOL:
        raise AssertionError(f"device per-song scores {gap} from the host's")

    # The host sweep's draws (score_inf: RandomState(seed).choice, in order),
    # and the device trace step on the first draw below n = d (where the step
    # keeps the top n - 1 eigenvalues), on the first at n >= 4d and on the
    # last (where the JAX package's step takes a 30-iteration Newton-Schulz
    # trace, printed beside the exact one).
    fad = FrechetAudioDistance(get_model("w2v2-base"), load_model=False)
    mu, cov = fad.load_stats(work / "baseline")
    embeds = fad._load_embeddings(sorted((work / "eval").glob("*.*")))
    max_n, d = embeds.shape
    rng = np.random.RandomState(0)
    base = FrechetBaseline(mu, cov)
    mu1, s1, tr1 = ds._baseline(mu, cov, torch.device("cuda"))
    checked = set()
    ns = [int(n) for n in np.linspace(500, max_n, 25)]
    for n in ns:
        sub = embeds[rng.choice(max_n, size=n, replace=True)]
        branch = "n < d" if n < d else "n >= 4d" if n >= 4 * d else None
        if n == ns[-1]:
            branch = "n = N, the last step"
        elif branch is None or branch in checked:
            continue
        checked.add(branch)
        host = base.distance(*calc_embd_statistics(sub))
        st = welford_update(welford_init(d, device="cuda"), torch.from_numpy(sub).cuda().float())
        mu2, cov2 = welford_finalize(st)
        dev = float(ds._fad_trace_step(mu1, s1, tr1, n, d, mu2, cov2))
        m = s1 @ cov2 @ s1
        ev = torch.linalg.eigvalsh((m + m.T) * 0.5)
        whole = float(ev.clamp(min=0.0).sqrt().sum())
        kept = float(ev[max(d - (n - 1), 0):].clamp(min=0.0).sqrt().sum())
        newton_schulz = float(torch.trace(_ns_sqrt_sym((m + m.T) * 0.5, 30)))
        print(f"[scoring] trace step ({branch}, n={n}, d={d}): device {dev} vs host float64 "
              f"{host}: relative {_rel(dev, host):.3e} (limit {TRACE_STEP_RTOL:g}); "
              f"eigenvalues of s1 C2 s1 {float(ev[0]):.3e} .. {float(ev[-1]):.3e}; Tr sqrt over "
              f"the top min(n - 1, d) {kept}, over the whole spectrum {whole}, by 30 "
              f"Newton-Schulz iterations {newton_schulz}", flush=True)
        if not _rel(dev, host) <= TRACE_STEP_RTOL:
            raise AssertionError(f"trace step ({branch}) {dev} vs host {host}")
    if len(checked) != 3:
        raise AssertionError(f"the sweep over {max_n} frames covers {checked} only")


def run_module(name: str, *argv) -> None:
    """``python -m <name> argv...`` in this process (so launch counts and
    patches reach it); a ``SystemExit`` with code 0 or None is success."""
    import runpy

    sys.argv = [name, *map(str, argv)]
    try:
        runpy.run_module(name, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code not in (0, None):
            raise


def embeds_check(torch, work: Path) -> None:
    """``python -m fadtk_tpu_torch.embeds`` over the 12 MERT-v1-95M variants
    on a fresh copy of the eval dataset's 16 clips: one backbone forward per
    file, every variant's caches written, and the default layer's ``.npy``
    against a per-variant ``cache_embedding_files`` run of MERT-v1-95M on
    another fresh copy (f32 both; the one-clip forward against the batched
    one sums in another order, so a float16 value may land one ulp away, at
    most 2^-10 of the file's largest value: the limit). Both wall times,
    convert included."""
    import shutil

    import numpy as np

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel
    from fadtk_tpu_torch.runner.batch import cache_embedding_files

    names = [f"MERT-v1-95M-{i}" for i in range(1, 12)] + ["MERT-v1-95M"]
    dirs = {label: work / f"embeds-{label}" for label in ("multi", "single")}
    for d in dirs.values():
        d.mkdir()
        for f in sorted((work / "eval").glob("*.wav")):
            shutil.copy(f, d / f.name)
    calls = []
    real = SpeechEmbeddingModel._forward

    def counted(self, audio, num_valid, taps):
        calls.append((audio.shape, taps))
        return real(self, audio, num_valid, taps)

    SpeechEmbeddingModel._forward = counted
    try:
        t0 = time.perf_counter()
        run_module("fadtk_tpu_torch.embeds", "-m", *names, "-d", dirs["multi"])
        torch.cuda.synchronize()
        multi_s = time.perf_counter() - t0
    finally:
        SpeechEmbeddingModel._forward = real
    n_files = len(list(dirs["multi"].glob("*.wav")))
    if len(calls) != n_files or any(taps is not None for _, taps in calls):
        raise AssertionError(f"embeds: {len(calls)} backbone forwards for {n_files} files: "
                             f"{calls}")
    for name in names:
        got = len(list((dirs["multi"] / "embeddings" / name).glob("*.npy")))
        if got != n_files:
            raise AssertionError(f"embeds: {got} {name} caches for {n_files} files")
    t0 = time.perf_counter()
    cache_embedding_files(dirs["single"], get_model("MERT-v1-95M"))
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    worst, flips, values = 0.0, 0, 0
    for f in sorted((dirs["single"] / "embeddings" / "MERT-v1-95M").glob("*.npy")):
        want = np.load(f).astype(np.float32)
        got = np.load(dirs["multi"] / "embeddings" / "MERT-v1-95M" / f.name).astype(np.float32)
        if got.shape != want.shape:
            raise AssertionError(f"embeds {f.name}: {got.shape} vs {want.shape}")
        worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
        flips, values = flips + int((got != want).sum()), values + want.size
    print(f"[embeds] 12 MERT-v1-95M variants, {n_files} files: {len(calls)} backbone forwards, "
          f"{multi_s:.3f} s; MERT-v1-95M alone through cache_embedding_files {single_s:.3f} s; "
          f"default layer vs the per-variant run: {flips} of {values} float16 values differ, "
          f"the largest by {worst:.3e} of its file's largest value (limit {2.0 ** -10:.3e})",
          flush=True)
    if not worst <= 2.0 ** -10:
        raise AssertionError(f"embeds: default layer differs from the per-variant run by {worst}")


def package_check(work: Path) -> None:
    """``python -m fadtk_tpu_torch.package`` on the eval dataset with
    ``--models w2v2-base cdpam-acoustic`` (their f32 caches exist): the
    ``.npz`` holds exactly the two stats caches."""
    import numpy as np

    out = work / "package" / "eval.npz"
    names = ("w2v2-base", "cdpam-acoustic")
    t0 = time.perf_counter()
    run_module("fadtk_tpu_torch.package", work / "eval", out, "--models", *names)
    with np.load(out) as z:
        want = sorted(f"{m}.{k}" for m in names for k in ("mu", "cov"))
        if sorted(z.files) != want:
            raise AssertionError(f"package: keys {sorted(z.files)}, expected {want}")
        for m in names:
            for k in ("mu", "cov"):
                if not np.array_equal(z[f"{m}.{k}"], np.load(work / "eval" / "stats" / m /
                                                             f"{k}.npy")):
                    raise AssertionError(f"package: {m}.{k} differs from the stats cache")
    print(f"[package] {out.name}: {want} equal to the stats caches, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def harness_check(work: Path, cached: dict) -> None:
    """``python -m fadtk_tpu_torch.test`` on w2v2-base with a golden CSV made
    from this run's own scores (the host ``--indiv`` CSV of the scoring phase
    and the CLI's whole-set score): exit 0 as made, 2 once perturbed."""
    indiv = work / "scoring--indiv.csv"
    rows = ["song_id,dataset,FAD_w2v2_base_fma_pop"]
    for line in indiv.read_text().strip().split("\n"):
        path, score = line.split(",")
        rows.append(f"{'/'.join(path.split('/')[-2:]).split('.')[0]},eval,{score}")
    rows.append(f"samples/all,eval,{cached['w2v2-base']['score']}")
    golden = work / "golden.csv"
    perturbed = work / "golden-perturbed.csv"
    golden.write_text("\n".join(rows) + "\n")
    perturbed.write_text("\n".join(
        [rows[0]] + [f"{r.rsplit(',', 1)[0]},{float(r.rsplit(',', 1)[1]) * 2 + 10}"
                     for r in rows[1:]]) + "\n")
    cwd = os.getcwd()
    os.chdir(work)  # comparison.csv lands in the working directory
    try:
        codes = {}
        for label, g in (("as made", golden), ("perturbed", perturbed)):
            try:
                run_module("fadtk_tpu_torch.test", "--samples", work / "eval", "--golden", g,
                           "--baseline", work / "baseline", "--out-dir",
                           work / f"harness-{label.replace(' ', '-')}", "--models", "w2v2-base")
                codes[label] = 0
            except SystemExit as e:
                codes[label] = e.code
            comparison = (work / "comparison.csv").read_text().strip()
            print(f"[harness] golden {label}: exit {codes[label]}; comparison.csv "
                  f"{comparison.splitlines()[-1]}", flush=True)
    finally:
        os.chdir(cwd)
    if codes != {"as made": 0, "perturbed": 2}:
        raise AssertionError(f"harness exit codes {codes}, expected 0 as made and 2 perturbed")


def scoring_timings(torch, work: Path, smi: str) -> None:
    """Host float64 against device scoring through the runner's entry points,
    at a baseline-sized frame matrix and a thousand songs (generated; the
    baseline a random full-rank Gaussian)."""
    import numpy as np

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    rng = np.random.default_rng(SEED)
    d, model = 768, get_model("w2v2-base")
    n_frames, n_songs, song_len = 100_000, 1000, 500
    root = work / "scoring"
    (root / "songs" / "embeddings" / model.name).mkdir(parents=True)
    a = rng.standard_normal((d, d), dtype=np.float32) / np.sqrt(d)
    base = root / "base.npz"
    np.savez(base, **{"w2v2-base.mu": rng.standard_normal(d) * 0.1,
                      "w2v2-base.cov": (a @ a.T).astype(np.float64) + 0.1 * np.eye(d)})
    frames = root / "frames.npy"
    np.save(frames, (rng.standard_normal((n_frames, d), dtype=np.float32) * 1.1 + 0.05
                     ).astype(np.float16))
    for i in range(n_songs):
        (root / "songs" / f"song{i:04d}.wav").write_bytes(b"")
        np.save(root / "songs" / "embeddings" / model.name / f"song{i:04d}.npy",
                (rng.standard_normal((song_len, d), dtype=np.float32) + 0.1).astype(np.float16))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sweeps = {}
    for label, device in (("host float64", False), ("device", True), ("device again", True)):
        fad = FrechetAudioDistance(model, load_model=False, device_scoring=device)
        sweeps[label], secs = timed(lambda: fad.score_inf(base, [frames], seed=SEED))
        print(f"[scoring timing] FAD-inf sweep, 25 steps, N={n_frames} x D={d} float16, "
              f"{label}: {secs:.3f} s; score {sweeps[label].score}, r2 {sweeps[label].r2} "
              f"({smi})", flush=True)
    if sweeps["device"] != sweeps["device again"]:
        raise AssertionError("the device FAD-inf sweep is not seed-reproducible")
    csvs = {}
    for label, device in (("host float64", False), ("device", True)):
        fad = FrechetAudioDistance(model, load_model=False, device_scoring=device)
        csvs[label], secs = timed(lambda: fad.score_individual(
            base, root / "songs", root / f"{label.split()[0]}.csv"))
        print(f"[scoring timing] per-song, {n_songs} songs x {song_len} frames x D={d}, "
              f"{label}: {secs:.3f} s ({smi})", flush=True)
    gap, n = _per_song_gap(csvs["host float64"], csvs["device"])
    print(f"[scoring timing] device vs host float64 per-song, {n} songs: largest relative gap "
          f"{gap:.3e} (limit {PER_SONG_RTOL:g})", flush=True)
    if not gap <= PER_SONG_RTOL:
        raise AssertionError(f"device per-song scores {gap} from the host's")
    gram = torch.randn((16, 512, d), device="cuda")
    gram = gram @ gram.transpose(1, 2)
    ms = cuda_ms(torch, lambda: torch.linalg.eigvalsh(gram), runs=5, groups=5)
    print(f"[scoring timing] torch.linalg.eigvalsh of one per-song batch, 16 x (512, 512) "
          f"float32 Grams: {ms:.3f} ms ({smi})", flush=True)


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

        from fadtk_tpu_torch.ops import attention_softmax as asm
        from fadtk_tpu_torch.ops import flash_attention as fa
        from fadtk_tpu_torch.ops import fused_log_mel as k3
        from fadtk_tpu_torch.ops import fused_resnet as fr
        from fadtk_tpu_torch.ops import linear_f32 as k6

        kernels = (fa, fr, k3, asm, k6)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, started together
            libs = list(pool.map(lambda m: m.library_path(), kernels))
        print(f"built {', '.join(str(lib.relative_to(REPO)) for lib in libs)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for lib in libs:
            log = lib.with_suffix(".log")
            if log.exists():
                print(log.read_text().strip(), flush=True)

        phase("kernels vs plain twins")
        k1 = check_kernel(torch, fa, torch.bfloat16, 499, 12, bias=False)
        k1_f32 = check_kernel(torch, fa, torch.float32, 499, 12, bias=False)
        check_kernel(torch, fa, torch.bfloat16, 749, 12, bias=False)
        k1_f32_749 = check_kernel(torch, fa, torch.float32, 749, 12, bias=False)
        k1b = check_kernel(torch, fa, torch.bfloat16, 499, 12, bias=True)
        k1b_f32 = check_kernel(torch, fa, torch.float32, 499, 12, bias=True)
        check_kernel(torch, fa, torch.bfloat16, 499, 16, bias=True)
        k2, k2g, k2_f32 = k2_checks(torch, fa)
        k4 = k4_path_checks(torch, fr)
        k3_entries = k3_path_checks(torch, k3)
        torch.cuda.empty_cache()
        k5 = k5_checks(torch, asm)
        torch.cuda.empty_cache()
        k6_entries = k6_checks(torch, k6)

        for model_name in ("w2v2-base", "wavlm-base-plus", "MERT-v1-95M"):
            phase(f"{model_name} f32: card vs cpu")
            m32, sr = card_vs_cpu(torch, model_name)
            if model_name == "w2v2-base":
                phase("w2v2-base f32 at T=499: FADTK_TPU_FLASH_F32=1 with and without "
                      "FADTK_TPU_FLASH_F32_MIN_T=256")
                min_t_launches = flash_f32_min_t_check(torch, fa, m32)
            if model_name == "MERT-v1-95M":
                phase("MERT-v1-95M f32 forward, B=16 at T=749: FADTK_TPU_FLASH_F32=1 and plain "
                      "attention")
                mert_f32 = mert_flash_f32_check(torch, fa, m32, sr)
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
        large = whisper_forward_breakdown(torch, "large", runs=3)
        phase("whisper tp: the tensor-parallel step at tp=1 on whisper-large, B=4, f32 and bf16")
        whisper_tp_check(torch, large, "whisper-large")
        del large
        torch.cuda.empty_cache()

        for name in ("clap-laion-music", "clap-laion-audio", "clap-2023"):
            phase(f"{name} f32: card vs cpu, one 10 s clip (ten chunks)")
            sr = 44100 if name == "clap-2023" else 48000
            clap = model_card_vs_cpu(torch, name, rng.standard_normal(10 * sr) * 0.1)
            phase(f"{name} forward, batch {CLAP_BATCH}: f32 and bf16")
            clap_forward_breakdown(torch, clap)
            del clap
            torch.cuda.empty_cache()

        from fadtk_tpu_torch.models.cdpam_impl import cdpam_forward

        phase("cdpam-acoustic and cdpam-content f32: card vs cpu, one 5.3 s clip at 22.05 kHz")
        clip = (rng.standard_normal(int(5.3 * 22050)) * 3000).astype(np.float32)
        for name in ("cdpam-content", "cdpam-acoustic"):
            cdpam = model_card_vs_cpu(torch, name, clip)
        phase("cdpam forward, batch of 128 chunks of 1 s: f32 and bf16")
        lengths = torch.full((128,), 22050, dtype=torch.int32, device="cuda")
        module_forward_breakdown(torch, cdpam, lambda m, x: cdpam_forward(m, x * 3e4, lengths),
                                 (128, 22050), 128.0, "chunk-s")
        del cdpam
        torch.cuda.empty_cache()

        phase("convert: convert_cli --dry-run on every recorded schema; dac-44kHz and "
              "clap-laion-music converted from seeded checkpoints, card vs cpu")
        convert_checks(torch, kernels, work)
        torch.cuda.empty_cache()

        phase("main paths: CLI w2v2-base, wavlm-base-plus, encodec-emb, encodec-emb-48k, "
              "dac-44kHz, whisper-base, vggish, clap-laion-music, clap-2023, cdpam-acoustic f32 "
              "and --bf16; MERT --bf16")
        launches, cached, seconds = cli_runs(torch, kernels, work)

        phase("device pipeline: CLI --device-pipeline w2v2-base, wavlm-base-plus f32 and --bf16, "
              "w2v2-base --batch 4 with checkpoints")
        pipeline = pipeline_runs(torch, kernels, work, cached, seconds)

        phase("device pipeline, chunked and whole-clip: CLI --device-pipeline vggish, "
              "whisper-base (f32 and --bf16), clap-laion-music, clap-2023, dac-44kHz, "
              "encodec-emb-48k, encodec-emb with the fused block (f32 and --bf16), "
              "cdpam-acoustic")
        dp_pipeline = dp_pipeline_runs(torch, kernels, work, cached, seconds)

        phase("device transport: --device-pipeline with FADTK_TPU_CONVERT_TRANSPORT=device "
              "(w2v2-base --bf16, whisper-base) against the host transport")
        transport = transport_runs(torch, kernels, work)
        phase("multihost: torch.distributed.run -m fadtk_tpu_torch w2v2-base --device-pipeline "
              "--multihost")
        multihost_check(work, pipeline["score w2v2-base"])

        phase("device pipeline: the w2v2-base f32 gap to the cached path, split by source")
        sys.path.insert(0, str(REPO / "scripts"))
        from torch_pipeline_gap_probe import format_gap, split_gap

        from fadtk_tpu_torch.models.registry import get_model

        w2v2 = get_model("w2v2-base")
        for ds in ("baseline", "eval"):
            print(format_gap(f"w2v2-base f32 {ds}", split_gap(w2v2, work / ds)), flush=True)
        del w2v2

        phase("scoring: CLI --inf / --indiv, host and --device-scoring, on w2v2-base's cache")
        scoring_checks(torch, kernels, work)
        phase("python -m fadtk_tpu_torch.test: the golden-score harness on w2v2-base")
        harness_check(work, cached)
        phase("python -m fadtk_tpu_torch.embeds: 12 MERT-v1-95M variants, one forward per file")
        embeds_check(torch, work)
        phase("python -m fadtk_tpu_torch.package: w2v2-base and cdpam-acoustic")
        package_check(work)
        phase("scoring: host float64 against device, FAD-inf sweep and per-song")
        scoring_timings(torch, work, smi)
        phase("graft twin: fadtk_tpu_torch.graft_entry entry() and dryrun_multichip(1)")
        graft_twin_check(torch)

        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise AssertionError("jax was imported")
        print(f"\nsmoke phases passed in {time.perf_counter() - started:.1f} s", flush=True)
        source = "fadtk_tpu_torch/csrc/flash_attention_packed.cu"

        def paths(key: str) -> dict:
            """A kernel's launches over the cached-path CLI runs, the
            non-speech ``--device-pipeline`` runs and (K3's Whisper form) the
            device-transport runs, and their sum."""
            by_path = {"cached": launches[key], "device_pipeline": dp_pipeline[key]}
            if key == "K3 whisper":
                by_path["device_transport"] = transport["K3"]
            return {"launches": sum(by_path.values()), "launches_by_path": by_path}

        print(json.dumps({"kernels": [
            {"name": "flash_attention_packed", "route": "cuda", "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:703",
             "launches": launches["K1"] + transport["K1"],
             "launches_by_path": {"cached": launches["K1"], "device_transport": transport["K1"]},
             **k1},
            {"name": "flash_attention_packed (factorized bias)", "route": "cuda",
             "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:703 (bias term :559-562)",
             "launches": launches["K1b"], **k1b},
            {"name": "flash_attention_packed (f32, 3xTF32; B=16 T=499, T=749 beside)",
             "route": "cuda", "source": source, "replaces": "fadtk_tpu/ops/flash_attention.py:703",
             "launches": mert_f32["launches"] + min_t_launches,
             "launches_by_path": {
                 "cached f32 CLI runs (knob off)": cached["w2v2-base"]["K1"],
                 "MERT-v1-95M f32 B=16 T=749, FADTK_TPU_FLASH_F32=1": mert_f32["launches"],
                 "w2v2-base f32 T=499, FADTK_TPU_FLASH_F32=1 FADTK_TPU_FLASH_F32_MIN_T=256":
                 min_t_launches},
             **k1_f32, "t749": k1_f32_749,
             "mert_f32_forward_ms": {"knob_on": mert_f32["ms_knob_on"],
                                     "knob_off": mert_f32["ms_knob_off"]}},
            {"name": "flash_attention_packed (f32, 3xTF32, factorized bias)", "route": "cuda",
             "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:703 (bias term :559-562)",
             "launches": cached["wavlm-base-plus"]["K1b"],
             "launches_by_path": {"cached f32 CLI runs (no caller: WavLM's f32 attention "
                                  "stays dense)": cached["wavlm-base-plus"]["K1b"]},
             **k1b_f32},
            {"name": "fused_resnet_causal (f32, one forward's four launches)", "route": "cuda",
             "source": "fadtk_tpu_torch/csrc/fused_resnet_causal.cu",
             "replaces": "fadtk_tpu/ops/fused_resnet.py:125",
             **paths("K4"), **k4["float32"]},
            {"name": "fused_resnet_causal (bf16 tensor cores, one forward's four launches)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/fused_resnet_causal.cu",
             "replaces": "fadtk_tpu/ops/fused_resnet.py:125",
             **paths("K4b"), **k4["bfloat16"]},
            {"name": "fused_log_mel (log10_clamp, Whisper B=16; folded FMA body)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/fused_log_mel.cu",
             "replaces": "fadtk_tpu/dsp/pallas_mel.py:86",
             **paths("K3 whisper"), **k3_entries["whisper"]},
            {"name": "fused_log_mel (db_clamp, CLAP-LAION 48 kHz B=32, strided view; FFT body)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/fused_log_mel.cu",
             "replaces": "fadtk_tpu/dsp/pallas_mel.py:86",
             **paths("K3 clap-laion"), **k3_entries["clap-laion"]},
            {"name": "fused_log_mel (db_clamp, MS-CLAP 44.1 kHz B=32, strided view; FFT body)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/fused_log_mel.cu",
             "replaces": "fadtk_tpu/dsp/pallas_mel.py:86",
             **paths("K3 clap-2023"), **k3_entries["clap-2023"]},
            {"name": "flash_attention (head-major, factorized bias)", "route": "cuda",
             "source": source, "replaces": "fadtk_tpu/ops/flash_attention.py:490",
             "launches": pipeline["K2"], **k2},
            {"name": "flash_attention (head-major, grouped grid)", "route": "cuda",
             "source": source, "replaces": "fadtk_tpu/ops/flash_attention.py:422",
             "launches": pipeline["K2g"], **k2g},
            {"name": "flash_attention (head-major, f32, 3xTF32, factorized bias)",
             "route": "cuda", "source": source,
             "replaces": "fadtk_tpu/ops/flash_attention.py:490",
             "launches": pipeline["K2 f32"],
             "launches_by_path": {"device pipeline f32 runs (no caller: WavLM's f32 attention "
                                  "stays dense)": pipeline["K2 f32"]},
             **k2_f32},
            {"name": "attention_softmax (f32, WavLM's gated bias; B=16 T=2999 H=16, T=499 "
             "beside)", "route": "cuda", "source": "fadtk_tpu_torch/csrc/attention_softmax.cu",
             "replaces": "none: port-only (XLA fuses the bias and softmax of "
                         "fadtk_tpu/models/speech/encoder.py::_attention_core)",
             "launches": cached["wavlm-base-plus"]["K5"] + pipeline["K5 gated"],
             "launches_by_path": {"cached": cached["wavlm-base-plus"]["K5"],
                                  "device_pipeline": pipeline["K5 gated"]},
             **k5["gated"]},
            {"name": "attention_softmax (f32, key mask alone; B=16 T=2999 H=12, T=499 beside)",
             "route": "cuda", "source": "fadtk_tpu_torch/csrc/attention_softmax.cu",
             "replaces": "none: port-only (XLA fuses the bias and softmax of "
                         "fadtk_tpu/models/speech/encoder.py::_attention_core)",
             "launches": launches["K5"] - cached["wavlm-base-plus"]["K5"]
             + pipeline["K5"] - pipeline["K5 gated"],
             "launches_by_path": {
                 "cached": launches["K5"] - cached["wavlm-base-plus"]["K5"],
                 "device_pipeline": pipeline["K5"] - pipeline["K5 gated"]},
             **k5["key mask"]},
            {"name": "linear_f32 (f32 projection, 3xTF32 wgmma; Whisper-large fc1, other "
             "shapes beside)", "route": "cuda", "source": "fadtk_tpu_torch/csrc/linear_f32.cu",
             "replaces": "none: port-only (XLA does the JAX package's dots)",
             "launches": launches["K6"] + pipeline["K6"] + dp_pipeline["K6"] + transport["K6"],
             "launches_by_path": {"cached": launches["K6"],
                                  "device_pipeline": pipeline["K6"] + dp_pipeline["K6"],
                                  "device_transport": transport["K6"]},
             **k6_entries.pop("whisper-large fc1"), "shapes": k6_entries},
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
