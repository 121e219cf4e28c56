"""Two checkouts on one card: every flash attention form and the MERT f32 forward, knob on and off.

    python3 scripts/torch_flash_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an older commit
unpacked with ``git archive`` into a directory that .gitignore lists). Each
runs in a process of its own, in the order given (parent, change, change,
parent compares two commits within one call), importing ``fadtk_tpu_torch``
from that root and building its kernels there. Per root, with
``chip_smoke.py``'s checks from this checkout (ragged n_valid, CUDA events
over back-to-back calls, the bound of the run's work, SDPA beside): K1 at
B=16 H=12 T=499 and T=749, K1b at T=499 (and H=16 in bf16), K2 with bias
(and at H=16 and H=6 in bf16), plain, grouped and through strided views,
each in bf16 and float32 as chip_smoke.py checks them; then MERT-v1-95M f32
forwards (random weights from a seed) of a batch of the 10 s
bucket (T=749) with the knob on and off, K1 launches per forward and the
two outputs' difference. Prints the card's name and power limit first. Run
from the root of a checkout on a machine with a Hopper card and nvcc.
"""

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def worker(root: Path) -> None:
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root))
    import torch

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.models.speech.encoder import SpeechEncoder, init_speech_encoder
    from fadtk_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"fadtk_tpu_torch imported from {fa.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fa.library_path()
    print(f"[{root}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        smoke.check_kernel(torch, fa, dtype, 499, 12, bias=False)
        smoke.check_kernel(torch, fa, dtype, 749, 12, bias=False)
        smoke.check_kernel(torch, fa, dtype, 499, 12, bias=True)
    smoke.check_kernel(torch, fa, torch.bfloat16, 499, 16, bias=True)
    smoke.k2_checks(torch, fa)
    smoke.check_k2(torch, fa, torch.float32, 12, "plain")
    smoke.check_k2(torch, fa, torch.float32, 12, "grouped")
    model = get_model("MERT-v1-95M")
    m32 = init_speech_encoder(SpeechEncoder(model.cfg),
                              torch.Generator().manual_seed(smoke.SEED)).eval().cuda()
    smoke.mert_flash_f32_check(torch, fa, m32, model.sr)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]))
        return
    roots = sys.argv[1:] or [str(HERE)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    for root in roots:
        print(f"\n== {root}", flush=True)
        subprocess.run([sys.executable, __file__, "--worker", root], check=True)


if __name__ == "__main__":
    main()
