"""Build-and-check probe of the port's fused SEANet residual-block kernel (K4)
and of ``nn.LSTM`` on one CUDA card.

    python3 scripts/torch_fused_resnet_probe.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds the kernel and prints the ptxas report (registers, shared memory,
spills). Then, for float32 and bf16 at the four call sites of one 24 kHz
encodec-emb forward of batch 16 x 10 s (C=32/T=240000, 64/120000, 128/30000,
256/6000) and two small ragged cases, prints the max abs error against the
plain twin, finiteness, and the mean CUDA-event time of 10 launches of the
kernel and of the twin. Last, the LSTM of the 24 kHz encoder (2 layers of
512, batch 16, 750 steps): float32 on the card (TF32 off) against the CPU,
and bf16 cast with a bare ``.to`` and with ``models.base.cast_module`` (its
weights re-flattened): time and compaction warnings of each. chip_smoke.py is the full check; this is
the short first call for a kernel edit.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.ops import fused_resnet as fr  # noqa: E402


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


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi.splitlines()[0] if smi else 'nvidia-smi: no output'}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.time()
    lib = fr.library_path()
    print(f"build {time.time() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text())
    dev = "cuda"
    for dtype in (torch.float32, torch.bfloat16):
        for b, c, t in ((16, 32, 240000), (16, 64, 120000), (16, 128, 30000), (16, 256, 6000),
                        (3, 64, 1001), (2, 32, 3), (2, 256, 70), (1, 128, 129)):
            g = torch.Generator(device=dev).manual_seed(c + t)
            x = (torch.randn((b, c, t), generator=g, device=dev) * 0.5).to(dtype)
            s1, s2 = (3 * c) ** -0.5, (c // 2) ** -0.5

            def u(*shape, s):
                return ((torch.rand(shape, generator=g, device=dev) * 2 - 1) * s).to(dtype)

            w = (u(c // 2, c, 3, s=s1), u(c // 2, s=s1), u(c, c // 2, s=s2), u(c, s=s2),
                 u(c, c, s=c ** -0.5), u(c, s=c ** -0.5))
            out = fr.fused_resnet_causal(x, *w)
            ref = fr.fused_resnet_causal_reference(x, *w)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            print(dtype, b, c, t, "err", err, "max|ref|", scale, "finite",
                  bool(torch.isfinite(out.float()).all()),
                  "ms", _ms(lambda: fr.fused_resnet_causal(x, *w)),
                  "plain_ms", _ms(lambda: fr.fused_resnet_causal_reference(x, *w)), flush=True)
            del x, out, ref

    lstm = torch.nn.LSTM(512, 512, num_layers=2)
    x = torch.randn(750, 16, 512, generator=torch.Generator().manual_seed(0)) * 0.1
    with torch.inference_mode():
        want = lstm(x)[0]
        gpu = lstm.to(dev)
        got = gpu(x.to(dev))[0].cpu()
        print("lstm f32 card vs cpu max abs", (got - want).abs().max().item(),
              "max|cpu|", want.abs().max().item(),
              "ms", _ms(lambda: gpu(x.to(dev))), flush=True)
        # bf16: a bare .to() leaves cuDNN's weight buffer scattered (a warning
        # and a compaction on every call); cast_module re-flattens it.
        import copy
        import warnings

        from fadtk_tpu_torch.models.base import cast_module

        x16 = x.to(dev, torch.bfloat16)
        for label, g16 in (("bare .to(bfloat16)", copy.deepcopy(gpu).to(torch.bfloat16)),
                           ("cast_module", cast_module(copy.deepcopy(gpu), torch.bfloat16))):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                got16 = g16(x16)[0].float().cpu()
                ms = _ms(lambda: g16(x16))
            n_warn = sum("contiguous chunk" in str(w.message) for w in seen)
            print(f"lstm bf16, {label}: max abs vs cpu f32 {(got16 - want).abs().max().item():.3e}"
                  f", {ms:.4f} ms, {n_warn} compaction warnings", flush=True)


if __name__ == "__main__":
    main()
