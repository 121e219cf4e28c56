#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fadtk_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card, the
CUDA toolkit and PyTorch built for CUDA. It builds the port's kernels from the
sources in the checkout and fails (non-zero exit, no result line) on any
failed check, on a machine without a usable card, or outside a checkout.

Phases:

1. environment: the card's name and power limit, torch and CUDA versions;
2. kernel build (nvcc, sm_90a), timed;
3. every kernel against its plain twin on the card, at the main path's shapes
   (w2v2 16 kHz bucket B=16/T=499 in bf16 and f32, the 24 kHz bucket T=749 in
   bf16), ragged n_valid; CUDA-event times of kernel and twin;
4. full-width w2v2-base forward (768 x 12 layers, random weights from a seed):
   f32 on the card against f32 on the CPU, same weights, one 10 s clip; then
   batch-16 forward times (f32, bf16, bf16 with plain attention) and the
   device time by kernel from torch.profiler;
5. the main path through the CLI (``fadtk_tpu_torch.cli.main.main``), f32
   then ``--bf16``, on two generated datasets of 16 WAV clips each (full 10 s
   and ragged 2-9 s clips, some at 44.1 kHz so the host resampler runs), with
   the kernel launch count read around the bf16 run;
6. one JSON line of kernel results, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
SR = 16000
HEADS, HEAD_DIM, BATCH = 12, 64, 16
# Tolerances, kernel vs plain twin on valid rows: bf16 rounds p to bf16 before
# the p·v product in a different order than the twin's f32 GEMM (~1e-2 at
# these magnitudes); f32 differs only by the online softmax's reordered sums.
ATOL = {"bfloat16": 2e-2, "float32": 1e-5}
RTOL_CARD_VS_CPU = 1e-3


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(torch, fn, runs: int = 25) -> float:
    """Median of per-call CUDA-event times (ms) after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(torch, fa, dtype, t: int) -> dict:
    """Kernel vs twin at (BATCH, t, HEADS*HEAD_DIM) with ragged n_valid."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + t)
    shape = (BATCH, t, HEADS * HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    nv_list = [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
    nv = torch.tensor([min(n, t) for n in nv_list], dtype=torch.int32, device=dev)

    out = fa.flash_attention_packed(q, k, v, nv, num_heads=HEADS)
    ref = fa.flash_attention_packed_reference(q, k, v, nv, num_heads=HEADS)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{dtype} T={t}: non-finite values in the kernel output")
    err = 0.0
    for b, n in enumerate(nv.tolist()):
        err = max(err, (out[b, :n].float() - ref[b, :n].float()).abs().max().item())
        dead = -(-n // 64) * 64  # first fully padded 64-row tile
        if dead < t and out[b, dead:].abs().max().item() != 0.0:
            raise AssertionError(f"{dtype} T={t} b={b}: fully padded tile not zero")
    tol = ATOL[str(dtype).split(".")[-1]]
    ms = cuda_ms(torch, lambda: fa.flash_attention_packed(q, k, v, nv, num_heads=HEADS))
    plain_ms = cuda_ms(
        torch, lambda: fa.flash_attention_packed_reference(q, k, v, nv, num_heads=HEADS)
    )
    full = torch.full_like(nv, t)
    full_ms = cuda_ms(torch, lambda: fa.flash_attention_packed(q, k, v, full, num_heads=HEADS))
    print(f"flash_attention_packed {dtype} B={BATCH} T={t} H={HEADS} D={HEAD_DIM}: "
          f"max_abs_err={err:.3e} (atol {tol:g}) ragged n_valid: kernel={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms; all keys valid: kernel={full_ms:.4f} ms", flush=True)
    if not err <= tol:
        raise AssertionError(f"{dtype} T={t}: kernel vs twin max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def card_vs_cpu(torch):
    """Full-width w2v2-base f32 forward on the card vs the CPU, same weights,
    one 10 s clip. Returns the card model."""
    import copy

    import numpy as np

    from fadtk_tpu_torch.models.speech.config import base_config
    from fadtk_tpu_torch.models.speech.encoder import (
        SpeechEncoder,
        init_speech_encoder,
        speech_encoder_forward,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = base_config(do_normalize=False)
    cpu_model = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(SEED)).eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy((rng.standard_normal((1, 10 * SR)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        want, mask = speech_encoder_forward(cpu_model, audio, taps=(cfg.num_layers,))
        cpu_s = time.perf_counter() - t0
        got, gmask = speech_encoder_forward(gpu_model, audio.cuda(), taps=(cfg.num_layers,))
        got = got.cpu()
    n = int(mask.sum())
    if n != cfg.num_output_frames(10 * SR) or int(gmask.sum()) != n:
        raise AssertionError(f"frame count {n} / {int(gmask.sum())}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite card output")
    diff = (got - want)[..., :n, :].abs().max().item()
    scale = want[..., :n, :].abs().max().item()
    print(f"w2v2-base f32 card vs cpu, 1 x 10 s, {n} frames x 768: max_abs_diff={diff:.3e} "
          f"max|cpu|={scale:.3e} relative={diff / scale:.3e} (limit {RTOL_CARD_VS_CPU:g}); "
          f"cpu forward {cpu_s:.2f} s", flush=True)
    if not diff <= RTOL_CARD_VS_CPU * scale:
        raise AssertionError(f"card vs cpu relative diff {diff / scale} > {RTOL_CARD_VS_CPU}")
    return gpu_model


def forward_breakdown(torch, m32) -> None:
    """Batch-16 forwards of the 10 s bucket (8 full clips, 8 ragged): median
    CUDA-event time in f32, bf16, and bf16 with the plain attention instead of
    the kernel; then device time by kernel from torch.profiler. Also warms up
    the libraries before the timed CLI runs."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from fadtk_tpu_torch.models.speech.encoder import speech_encoder_forward

    m16 = copy.deepcopy(m32).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    n = 10 * SR
    audio = torch.randn((BATCH, n), generator=g, device="cuda") * 0.1
    nv = torch.tensor([n] * 8 + [n * (i + 2) // 10 for i in range(8)], dtype=torch.int32,
                      device="cuda")
    audio_s = nv.sum().item() / SR

    def forward(model):
        with torch.inference_mode():
            return speech_encoder_forward(model, audio, nv, taps=(12,))

    for name, model, flash in (("f32", m32, ""), ("bf16", m16, ""),
                               ("bf16 plain attention", m16, "0")):
        os.environ["FADTK_TPU_FLASH_ATTENTION"] = flash
        ms = cuda_ms(torch, lambda: forward(model), runs=10)
        print(f"forward {name}: {ms:.3f} ms per batch of 16 = {audio_s / ms * 1e3:.1f} "
              f"audio-s/s ({audio_s:.1f} s of valid audio in the 10 s bucket)", flush=True)
    os.environ.pop("FADTK_TPU_FLASH_ATTENTION")

    for name, model in (("f32", m32), ("bf16", m16)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward(model)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3
        busy = sum(kernels.values())
        if not busy:
            print(f"[{name}] device time by kernel: not measured (no device events)")
            continue
        print(f"[{name}] one forward: wall {wall_ms:.2f} ms, device kernels {busy:.2f} ms, "
              f"idle share {1 - busy / wall_ms:.3f}; top kernels:", flush=True)
        for k, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {t:8.3f} ms {100 * t / busy:5.1f}%  {k[:100]}", flush=True)


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


def cli_runs(torch, fa) -> int:
    """Both CLI modes over two generated datasets; returns the bf16 run's
    kernel launch count."""
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.runner import profiling

    work = Path(tempfile.mkdtemp(prefix="fadtk_tpu_torch_smoke_"))
    os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
    os.environ["FADTK_TPU_CHECKPOINTS"] = str(work / "checkpoints")
    os.environ.pop("FADTK_TPU_BF16", None)
    os.environ.pop("FADTK_TPU_FLASH_F32", None)
    seconds = make_dataset(work, "baseline", SEED + 1) + make_dataset(work, "eval", SEED + 2)

    reports: list[dict] = []
    real_report = profiling.report

    def capture(reset: bool = True):
        reports.append(real_report(reset))
        return reports[-1]

    profiling.report = capture
    csv = work / "scores.csv"
    launches = {}
    try:
        for mode, extra in (("f32", []), ("bf16", ["--bf16"])):
            reports.clear()
            fa.flash_attention_packed.launches = 0
            sys.argv = ["fadtk", "w2v2-base", str(work / "baseline"), str(work / "eval"),
                        str(csv), *extra]
            cli.main()
            torch.cuda.synchronize()
            launches[mode] = fa.flash_attention_packed.launches
            embed_s = sum(r.get("embed", 0.0) for r in reports)
            print(f"[{mode}] profile per dataset: {reports}", flush=True)
            print(f"[{mode}] embed stage: {seconds:.1f} audio-s in {embed_s:.3f} s = "
                  f"{seconds / embed_s:.1f} audio-s/s; kernel launches {launches[mode]}",
                  flush=True)
    finally:
        profiling.report = real_report
        os.environ.pop("FADTK_TPU_BF16", None)

    rows = csv.read_text().strip().split("\n")
    print("\n".join(rows), flush=True)
    if rows[0] != "model,baseline,eval,score,inf_r2,time" or len(rows) != 3:
        raise AssertionError(f"unexpected CSV: {rows}")
    for row, key in zip(rows[1:], ("w2v2-base", "w2v2-base-bf16")):
        fields = row.split(",")
        score = float(fields[3])
        if fields[0] != key or not score == score or score in (float("inf"), float("-inf")):
            raise AssertionError(f"bad CSV row {row!r}")
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.models.speech.config import base_config

    frames = base_config().num_output_frames
    for ds in ("baseline", "eval"):
        for key in ("w2v2-base", "w2v2-base-bf16"):
            embs = sorted((work / ds / "embeddings" / key).glob("*.npy"))
            if len(embs) != 16:
                raise AssertionError(f"{ds}/{key}: {len(embs)} embedding files")
            for f in embs:
                e = np.load(f)
                wav = work / ds / "convert" / str(SR) / f.with_suffix(".wav").name
                n = read_wav_int16(wav)[0].shape[0]
                if e.dtype != np.float16 or e.shape != (frames(n), 768) or not np.isfinite(e).all():
                    raise AssertionError(f"{f}: {e.dtype} {e.shape}, expected ({frames(n)}, 768)")
            for stat in ("mu.npy", "cov.npy"):
                if not (work / ds / "stats" / key / stat).exists():
                    raise AssertionError(f"{ds}/stats/{key}/{stat} missing")
    n_batches = 2  # one 10 s bucket of 16 clips per dataset
    if launches["f32"] != 0:
        raise AssertionError(f"f32 run launched the kernel {launches['f32']} times")
    if launches["bf16"] != 12 * n_batches:
        raise AssertionError(f"bf16 run: {launches['bf16']} launches, expected {12 * n_batches}")
    return launches["bf16"]


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
        from fadtk_tpu_torch.ops import flash_attention as fa

        t0 = time.perf_counter()
        lib = fa.library_path()
        print(f"built {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s", flush=True)
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

        phase("kernel vs plain twin")
        bf16 = check_kernel(torch, fa, torch.bfloat16, 499)
        check_kernel(torch, fa, torch.float32, 499)
        check_kernel(torch, fa, torch.bfloat16, 749)

        phase("w2v2-base f32: card vs cpu")
        m32 = card_vs_cpu(torch)

        phase("w2v2-base forward: time and device time by kernel")
        forward_breakdown(torch, m32)
        del m32

        phase("main path: CLI f32 and --bf16")
        launches = cli_runs(torch, fa)

        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise AssertionError("jax was imported")
        print(f"\nsmoke phases passed in {time.perf_counter() - started:.1f} s", flush=True)
        print(json.dumps({"kernels": [{
            "name": "flash_attention_packed",
            "route": "cuda",
            "source": "fadtk_tpu_torch/csrc/flash_attention_packed.cu",
            "replaces": "fadtk_tpu/ops/flash_attention.py:703",
            "launches": launches,
            **bf16,
        }]}))
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
