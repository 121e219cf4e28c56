"""Build-and-check probe of the port's fused log-mel kernel (K3) on one CUDA card.

    python3 scripts/torch_fused_log_mel_probe.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds the kernel and prints the ptxas report (registers, shared memory,
spills). Then, in each log mode, prints the max abs error against the plain
twin and the mean CUDA-event time of 10 launches of the kernel and of the
twin: at Whisper's geometry (B=16 x 3000 frames of 400 read through the
strided view of the padded signal, F=201, M=80), at VGGish's bases on
contiguous frames (N=24576, W=400, F=257, M=64), at CLAP's (N=16016,
W=1024, F=513, M=64), and at small ragged shapes (Whisper's folded bases and VGGish's unfolded ones). Last, Whisper's whole
frontend on the card against the CPU. chip_smoke.py is the full check; this
is the short first call for a kernel edit.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.dsp import mel as dmel  # noqa: E402
from fadtk_tpu_torch.ops import fused_log_mel as k3  # noqa: E402


def _ms(fn, runs: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def _check(label, frames, bases, mode, offset=0.0, timed=True):
    out = k3.fused_log_mel(frames, *bases, log_mode=mode, log_offset=offset)
    ref = k3.fused_log_mel_reference(frames, *bases, log_mode=mode, log_offset=offset)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    line = (f"{label} {mode}: {tuple(out.shape)} finite={bool(torch.isfinite(out).all())} "
            f"max_abs_err={err:.3e} max|ref|={ref.abs().max().item():.3f}")
    if timed:
        line += (f" kernel={_ms(lambda: k3.fused_log_mel(frames, *bases, log_mode=mode, log_offset=offset)):.4f} ms"
                 f" twin={_ms(lambda: k3.fused_log_mel_reference(frames, *bases, log_mode=mode, log_offset=offset)):.4f} ms")
    print(line, flush=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi.splitlines()[0] if smi else 'nvidia-smi: no output'}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    lib = k3.library_path()
    print(f"build {time.time() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    audio = torch.randn((16, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1
    wb = dmel._device_bases("whisper", dev)
    for mode in k3.LOG_MODES:
        _check("whisper B=16 strided", dmel.whisper_frames(audio), wb, mode, 0.01)
    vb = dmel._device_bases("vggish", dev)
    frames = torch.randn((24576, 400), generator=g, device=dev) * 0.1
    _check("vggish N=24576", frames, vb, "ln_offset", 0.01)
    cb = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    frames = torch.randn((16016, 1024), generator=g, device=dev) * 0.1
    _check("clap N=16016", frames, cb, "db_clamp")
    for n in (1, 65, 130):
        frames = torch.randn((3, n, 400), generator=g, device=dev) * 0.1
        _check(f"ragged B=3 N={n} folded", frames, wb, "log10_clamp", timed=False)
        _check(f"ragged B=3 N={n} unfolded", frames, vb, "ln_offset", 0.01, timed=False)
    print("bases fold: " + ", ".join(f"{name} {k3.kernel_layout(*b).fold}"
                                     for name, b in (("whisper", wb), ("vggish", vb),
                                                     ("clap", cb))), flush=True)

    torch.backends.cudnn.allow_tf32 = False
    want = dmel.whisper_log_mel(audio[:2].cpu())
    got = dmel.whisper_log_mel(audio[:2]).cpu()
    print(f"whisper_log_mel card vs cpu: max_abs_diff={(got - want).abs().max().item():.3e} "
          f"max|cpu|={want.abs().max().item():.3f}; launches={k3.fused_log_mel.launches}")


if __name__ == "__main__":
    main()
