"""Build-and-check probe of the port's fused log-mel kernel (K3) on one CUDA card.

    python3 scripts/torch_fused_log_mel_probe.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds the kernel and prints the ptxas report (registers, shared memory,
spills). Then prints, for each case, the body that serves the bases, the
max abs error against the plain twin and, where timed, the mean CUDA-event
time of 10 launches of the kernel, of the twin and of the torch.stft chain
(VGGish: the windowed frames' rfft alone):
CLAP's frontends at one forward's batch (B=32 chunks read through the
strided view: 48 kHz hop 480, 44.1 kHz hop 320; FFT body), also through
the folded FMA body on the same frames (the body CLAP's bases took before
the FFT body); Whisper's geometry (B=16 x 3000 frames of 400, folded body)
in each log mode; VGGish's bases (N=24576, FFT body, n_fft 512); small
ragged shapes through every body, an odd hop (the FFT body's one-float
loads) and random (1024, 513) bases (the unfolded body). Last, Whisper's
whole frontend on the card against the CPU. chip_smoke.py is the full
check; this is the short first call for a kernel edit.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.dsp import mel as dmel  # noqa: E402
from fadtk_tpu_torch.ops import fused_log_mel as k3  # noqa: E402

ATOL = {"ln_offset": 1e-4, "log10_clamp": 1e-4, "db_clamp": 1e-3}


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


def _check(label, frames, bases, mode, offset=0.0, chain=None):
    def kernel():
        return k3.fused_log_mel(frames, *bases, log_mode=mode, log_offset=offset)

    def twin():
        return k3.fused_log_mel_reference(frames, *bases, log_mode=mode, log_offset=offset)

    out, ref = kernel(), twin()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    line = (f"{label} {mode} [{k3.kernel_layout(*bases).body}]: {tuple(out.shape)} "
            f"finite={bool(torch.isfinite(out).all())} max_abs_err={err:.3e} "
            f"max|ref|={ref.abs().max().item():.3f}")
    if chain is not None:
        line += (f" kernel={_ms(kernel):.4f} ms twin={_ms(twin):.4f} ms "
                 f"stft chain={_ms(chain):.4f} ms")
    print(line, flush=True)
    if not err <= ATOL[mode]:
        raise AssertionError(f"{label}: {err} > {ATOL[mode]}")


def _folded_ms(frames, bases, mode):
    """The folded FMA body on CLAP's frames and bases (what served them
    before the FFT body): its error against the twin and its time."""
    layout = k3._fma_layout(*bases)
    b, n, w = frames.shape
    f, m = bases[2].shape
    out = torch.empty((b, n, m), device=frames.device)
    _, kp, fp = layout.bases.shape

    def run():
        rc = k3._library().fadtk_fused_log_mel(
            frames.data_ptr(), frames.stride(0), frames.stride(1), b, n, w, int(layout.fold),
            layout.bases.data_ptr(), kp, fp, f, bases[2].data_ptr(), layout.band.data_ptr(), m,
            out.data_ptr(), k3.LOG_MODES[mode], 0.0,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    ref = k3.fused_log_mel_reference(frames, *bases, log_mode=mode)
    err = (run() - ref).abs().max().item()
    return err, _ms(run)


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

    def stft_power(x, n_fft, hop, win_length, center):
        window = torch.hann_window(win_length, periodic=True, device=dev)
        spec = torch.stft(x, n_fft, hop, win_length=win_length, window=window, center=center,
                          pad_mode="reflect", return_complex=True)
        return spec.abs() ** 2

    for sr, seconds, hop in ((48000, 10, 480), (44100, 7, 320)):
        chunks = torch.randn((32, sr * seconds), generator=g, device=dev) * 0.1
        cb = dmel._device_bases("torchlibrosa", dev, 1024, sr, 64, 50.0, 14000.0)
        frames = dmel.torchlibrosa_frames(chunks, 1024, hop)
        _check(f"clap {sr} B=32 hop {hop} strided", frames, cb, "db_clamp",
               chain=lambda: 10.0 * torch.log10(torch.clamp_min(
                   stft_power(chunks, 1024, hop, 1024, True).transpose(1, 2) @ cb[2], 1e-10)))
        err, ms = _folded_ms(frames, cb, "db_clamp")
        print(f"  the folded FMA body on the same frames: max_abs_err={err:.3e} {ms:.4f} ms",
              flush=True)

    audio = torch.randn((16, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1
    wb = dmel._device_bases("whisper", dev)
    for mode in k3.LOG_MODES:
        _check("whisper B=16 strided", dmel.whisper_frames(audio), wb, mode, 0.01,
               chain=lambda: stft_power(audio, 400, 160, 400, True))
    vb = dmel._device_bases("vggish", dev)
    frames = torch.randn((24576, 400), generator=g, device=dev) * 0.1
    _check("vggish N=24576", frames, vb, "ln_offset", 0.01,
           chain=lambda: torch.fft.rfft(torch.nn.functional.pad(frames * vb[0][:, 0], (0, 112))))
    cb = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    rb = [torch.randn((1024, 513), generator=g, device=dev) * 0.05 for _ in range(2)]
    rb.append(torch.rand((513, 64), generator=g, device=dev) * 0.01)
    for n in (1, 63, 65, 130):
        frames = torch.randn((3, n, 1024), generator=g, device=dev) * 0.1
        _check(f"ragged B=3 N={n} clap", frames, cb, "db_clamp")
        _check(f"ragged B=3 N={n} random bases", frames, rb, "ln_offset", 0.01)
        frames = torch.randn((3, n, 400), generator=g, device=dev) * 0.1
        _check(f"ragged B=3 N={n} whisper", frames, wb, "log10_clamp")
        _check(f"ragged B=3 N={n} vggish", frames, vb, "ln_offset", 0.01)
    sig = torch.randn((2, 321 * 40), generator=g, device=dev) * 0.1
    _check("clap hop 321 (one-float loads)", dmel.torchlibrosa_frames(sig, 1024, 321), cb,
           "log10_clamp")
    print(f"launches: FMA bodies {k3.fused_log_mel.launches}, FFT body "
          f"{k3.fused_log_mel.fft_launches}", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    want = dmel.whisper_log_mel(audio[:2].cpu())
    got = dmel.whisper_log_mel(audio[:2]).cpu()
    print(f"whisper_log_mel card vs cpu: max_abs_diff={(got - want).abs().max().item():.3e} "
          f"max|cpu|={want.abs().max().item():.3f}")


if __name__ == "__main__":
    main()
