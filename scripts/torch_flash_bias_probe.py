"""Build-and-check probe of the port's packed flash-attention kernel, both
forms (no bias, and WavLM's factorized gated bias), on one CUDA card.

    python3 scripts/torch_flash_bias_probe.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
Builds the kernel, prints the ptxas report (registers, shared memory,
spills), and for bf16 and f32 at B=16 T=499 H=12, B=16 T=499 H=16 and a
small ragged case prints the max abs error against the plain twin on valid
rows, finiteness, whether fully padded 64-row tiles are zero, and the mean
CUDA-event time of 20 launches. chip_smoke.py is the full check; this is
the short first call for a new kernel.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main() -> None:
    t0 = time.time()
    lib = fa.library_path()
    print(f"build {time.time() - t0:.1f} s")
    print(lib.with_suffix(".log").read_text())
    dev = "cuda"
    for dtype in (torch.bfloat16, torch.float32):
        for b_, t, h in ((16, 499, 12), (16, 499, 16), (3, 130, 2)):
            g = torch.Generator(device=dev).manual_seed(t)
            q, k, v = (torch.randn((b_, t, h * 64), generator=g, device=dev).to(dtype)
                       for _ in range(3))
            pb = torch.randn((h, t, t), generator=g, device=dev)
            gate = torch.rand((b_, t, h), generator=g, device=dev) * 2 + 1
            nv_list = ([1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
                       * 2)[:b_]
            nv = torch.tensor([min(n, t) for n in nv_list], dtype=torch.int32, device=dev)
            for bias in (False, True):
                args = (pb, gate) if bias else (None, None)
                out = fa.flash_attention_packed(q, k, v, nv, *args, num_heads=h)
                ref = fa.flash_attention_packed_reference(q, k, v, nv, *args, num_heads=h)
                torch.cuda.synchronize()
                err, zero = 0.0, True
                for b, n in enumerate(nv.tolist()):
                    err = max(err, (out[b, :n].float() - ref[b, :n].float()).abs().max().item())
                    dead = -(-n // 64) * 64
                    if dead < t:
                        zero &= out[b, dead:].abs().max().item() == 0
                for _ in range(3):
                    fa.flash_attention_packed(q, k, v, nv, *args, num_heads=h)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fa.flash_attention_packed(q, k, v, nv, *args, num_heads=h)
                end.record()
                end.synchronize()
                print(dtype, b_, t, h, "bias" if bias else "nobias", "err", err, "finite",
                      bool(torch.isfinite(out.float()).all()), "zeros", zero,
                      "ms", start.elapsed_time(end) / 20, flush=True)


if __name__ == "__main__":
    main()
