"""Where K6 (``csrc/linear_f32.cu``) overtakes cuBLAS float32: the sweep
behind the floors of ``ops/linear_f32.py`` (``MIN_ROWS``, ``MIN_COLUMNS``).

    python scripts/torch_linear_f32_probe.py

Prints the card's name and power limit, then the kernel's and cuBLAS's
(TF32 off) time and their ratio for x (M, K) · W (N, K)ᵀ: over the row count
M at the cells' widths, over the depth K, and over the output width N.
Checking the kernel and timing it at the cells' shapes are
``chip_smoke.py``'s K6 phase and ``tests/test_torch_linear_f32.py``'s. Needs
a card.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fadtk_tpu_torch.ops import linear_f32 as lf  # noqa: E402

ROWS = [256, 512, 1024, 2048, 4096, 8192]
SWEEPS = {  # name: [(K, N)], [M]
    "rows": ([(1280, 1280), (1280, 5120), (768, 768), (1024, 4096), (512, 768)], ROWS),
    "depth": ([(k, n) for n in (768, 1024) for k in (64, 96, 128, 192, 256, 384)],
              [1024, 8192, 47984]),
    "columns": ([(k, n) for k in (768, 1024) for n in (8, 16, 32, 64, 128)],
                [1024, 8192, 47984]),
}


def timed(fn, reps=50):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (widths, rows) in SWEEPS.items():
        for k, n in widths:
            for m in rows:
                x = torch.randn((m, k), generator=g, device=dev)
                w = torch.randn((n, k), generator=g, device=dev) / k ** 0.5
                ms = timed(lambda: lf.linear_f32(x, w))
                ms_lib = timed(lambda: torch.nn.functional.linear(x, w))
                print(f"{name} K={k} N={n} M={m}: kernel {ms:.4f} ms, cublas {ms_lib:.4f} ms, "
                      f"x{ms_lib / ms:.2f}", flush=True)


if __name__ == "__main__":
    main()
