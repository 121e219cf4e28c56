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
3. every kernel against its plain twin on the card, at the main paths'
   shapes, ragged n_valid, with CUDA-event times of kernel, twin and one
   PyTorch library call for the same function (a yardstick the port never
   calls), and the roofline bound of the run's work:
   - K1, flash attention without bias: the w2v2/HuBERT 16 kHz bucket
     B=16/T=499/H=12 in bf16 and f32, MERT's 24 kHz bucket T=749 in bf16;
   - K1b, the same kernel with WavLM's factorized gated bias: B=16/T=499 in
     bf16 and f32 at H=12 (wavlm-base-plus) and bf16 at H=16 (wavlm-large);
4. full-width forwards (random weights from a seed) of w2v2-base,
   wavlm-base-plus and MERT-v1-95M (24 kHz, T=749): f32 on the card against
   f32 on the CPU, same weights, one 10 s clip; then batch-16 forward times
   for each (f32, bf16, bf16 with plain attention) and the device time by
   kernel from torch.profiler;
5. the main paths through the CLI (``fadtk_tpu_torch.cli.main.main``) on two
   generated datasets of 16 WAV clips each (full 10 s and ragged 2-9 s clips,
   some at 44.1 kHz so the host resampler runs): w2v2-base and
   wavlm-base-plus in f32 and ``--bf16``, MERT-v1-95M ``--bf16`` (resampled to
   24 kHz). Both kernel launch counts are set to 0 just before each run and
   read just after it;
6. one JSON line of kernel results, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
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
HEAD_DIM, BATCH = 64, 16
# Tolerances, kernel vs plain twin on valid rows: in bf16 both round the
# unnormalised p to bf16 before the p·v product, at different running maxima
# and in a different order (about one bf16 ulp of the output); f32 differs
# only by the online softmax's reordered sums.
ATOL = {"bfloat16": 2e-2, "float32": 1e-5}
RTOL_CARD_VS_CPU = 1e-3
# Roofline of one H100 SXM (NVIDIA data sheet; dense, at 700 W): memory rate
# and peak rates by input type (bf16 on tensor cores, f32 on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


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
          f"({bound['gflop']:.3f} GFLOP, {bound['mbytes']:.2f} MB); "
          f"all keys valid: kernel={full_ms:.4f} ms", flush=True)
    del mask, ref, out
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs twin max_abs_err {err} > {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": library_ms}


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

    from torch.profiler import ProfilerActivity, profile

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
            print(f"[{model_name} {name}] device time by kernel: not measured (no device events)")
            continue
        print(f"[{model_name} {name}] one forward: wall {wall_ms:.2f} ms, device kernels "
              f"{busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}; top kernels:", flush=True)
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


def cli_run(torch, fa, work: Path, seconds: float, model_name: str, bf16: bool) -> dict:
    """One CLI run over the two datasets; checks the CSV row and the
    embedding caches. Returns the kernel launch counts by form (set to 0
    just before the run, read just after it) and the number of device
    batches the run made."""
    import numpy as np

    from fadtk_tpu_torch.audio.wavio import read_wav_int16
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner import profiling
    from fadtk_tpu_torch.utils import next_multiple

    model = get_model(model_name)
    key = model_name + ("-bf16" if bf16 else "")
    csv = work / f"scores-{key}.csv"
    reports: list[dict] = []
    real_report = profiling.report

    def capture(reset: bool = True):
        reports.append(real_report(reset))
        return reports[-1]

    profiling.report = capture
    sys.argv = ["fadtk", model_name, str(work / "baseline"), str(work / "eval"), str(csv),
                *(["--bf16"] if bf16 else [])]
    try:
        fa.flash_attention_packed.launches = 0
        fa.flash_attention_packed.bias_launches = 0
        cli.main()
        torch.cuda.synchronize()
        launches = {"K1": fa.flash_attention_packed.launches,
                    "K1b": fa.flash_attention_packed.bias_launches}
    finally:
        profiling.report = real_report
        os.environ.pop("FADTK_TPU_BF16", None)
    embed_s = sum(r.get("embed", 0.0) for r in reports)
    print(f"[{key}] profile per dataset: {reports}", flush=True)
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

    frames, bucket = model.cfg.num_output_frames, 10 * model.sr
    n_batches = 0
    for ds in ("baseline", "eval"):
        embs = sorted((work / ds / "embeddings" / key).glob("*.npy"))
        if len(embs) != 16:
            raise AssertionError(f"{ds}/{key}: {len(embs)} embedding files")
        buckets: dict[int, int] = {}
        for f in embs:
            e = np.load(f)
            wav = work / ds / "convert" / str(model.sr) / f.with_suffix(".wav").name
            n = read_wav_int16(wav)[0].shape[0]
            b = next_multiple(max(n, 1), bucket)
            buckets[b] = buckets.get(b, 0) + 1
            want = (frames(n), model.num_features)
            if e.dtype != np.float16 or e.shape != want or not np.isfinite(e).all():
                raise AssertionError(f"{f}: {e.dtype} {e.shape}, expected float16 {want}")
        n_batches += sum(-(-c // model.MAX_BATCH) for c in buckets.values())
        for stat in ("mu.npy", "cov.npy"):
            if not (work / ds / "stats" / key / stat).exists():
                raise AssertionError(f"{ds}/stats/{key}/{stat} missing")
    return {**launches, "batches": n_batches}


def cli_runs(torch, fa) -> dict:
    """Every main path through the CLI, on two generated datasets. Returns
    the launches of each kernel summed over the runs that must launch it."""
    work = Path(tempfile.mkdtemp(prefix="fadtk_tpu_torch_smoke_"))
    os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
    os.environ["FADTK_TPU_CHECKPOINTS"] = str(work / "checkpoints")
    os.environ.pop("FADTK_TPU_BF16", None)
    os.environ.pop("FADTK_TPU_FLASH_F32", None)
    seconds = make_dataset(work, "baseline", SEED + 1) + make_dataset(work, "eval", SEED + 2)

    # (model, bf16, kernel that must launch 12 times per device batch or None)
    runs = [("w2v2-base", False, None), ("w2v2-base", True, "K1"),
            ("wavlm-base-plus", False, None), ("wavlm-base-plus", True, "K1b"),
            ("MERT-v1-95M", True, "K1")]
    totals = {"K1": 0, "K1b": 0}
    for model_name, bf16, kernel in runs:
        got = cli_run(torch, fa, work, seconds, model_name, bf16)
        want = {"K1": 0, "K1b": 0}
        if kernel:
            want[kernel] = 12 * got["batches"]
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{model_name} bf16={bf16}: launches {got}, expected {want} "
                                 f"({got['batches']} device batches)")
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
        from fadtk_tpu_torch.ops import flash_attention as fa

        t0 = time.perf_counter()
        lib = fa.library_path()
        print(f"built {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s", flush=True)
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
        torch.cuda.empty_cache()

        for model_name in ("w2v2-base", "wavlm-base-plus", "MERT-v1-95M"):
            phase(f"{model_name} f32: card vs cpu")
            m32, sr = card_vs_cpu(torch, model_name)
            phase(f"{model_name} forward: time and device time by kernel")
            forward_breakdown(torch, m32, model_name, sr)
            del m32
            torch.cuda.empty_cache()

        phase("main paths: CLI w2v2-base and wavlm-base-plus f32 and --bf16, MERT --bf16")
        launches = cli_runs(torch, fa)

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
