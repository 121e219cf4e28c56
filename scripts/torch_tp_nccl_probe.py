"""Multi-process check of the device pipeline's (dp, tp) step: the sharded
run against a single-device run of the same clips, on every rank.

    torchrun --nproc-per-node 4 scripts/torch_tp_nccl_probe.py --tp 2

One process per GPU (NCCL), or per CPU process with FADTK_TPU_TORCH_DEVICE=cpu
(gloo). Rank 0 writes ``--clips`` generated 16 kHz WAVs (ragged, 2 s to
``--seconds``) to a temporary directory; then, for w2v2-base and
wavlm-base-plus (random weights from seed 0) in f32 and bf16, every rank runs
``dataset_stats_device`` on the job's (dp, tp) mesh and again on a one-rank
mesh of its own device, and rank 0 prints n, the largest |mu| and |cov|
differences relative to the single-device values, each kernel's launches in
the sharded run, and both wall times. Fails (exit 1) unless n is equal and
the f32 differences are within 1e-4 of the largest value (bf16: 5e-2) on
every rank. A CPU rehearsal: ``FADTK_TPU_TORCH_DEVICE=cpu torchrun
--nproc-per-node 4 scripts/torch_tp_nccl_probe.py --clips 3 --seconds 3
--batch 2``.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16  # noqa: E402
from fadtk_tpu_torch.models.registry import get_model  # noqa: E402
from fadtk_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fadtk_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device  # noqa: E402

RTOL = {False: 1e-4, True: 5e-2}


def make_clips(d: Path, n: int, seconds: float) -> None:
    rng = np.random.default_rng(0)
    for i in range(n):
        t = np.arange(int(16000 * rng.uniform(2.0, seconds))) / 16000
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav_int16(d / f"clip{i:02d}.wav", float_to_int16(x), 16000)


def run(model, files, mesh, batch: int) -> tuple:
    for name in ("launches", "bias_launches", "grouped_launches"):
        setattr(fa.flash_attention, name, 0)
    fa.flash_attention_packed.launches = fa.flash_attention_packed.bias_launches = 0
    t0 = time.perf_counter()
    out = dataset_stats_device(model, files, mesh=mesh, batch=batch, workers=2)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    launches = (fa.flash_attention_packed.launches + fa.flash_attention_packed.bias_launches,
                fa.flash_attention.launches + fa.flash_attention.bias_launches)
    return out, launches, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=32, help="clips per step (a multiple of dp)")
    args = ap.parse_args()
    os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
    mesh = make_mesh(tp=args.tp)
    work = [tempfile.mkdtemp(prefix="tp_probe_") if mesh.rank == 0 else None]
    dist.broadcast_object_list(work, src=0)
    work = Path(work[0])
    if mesh.rank == 0:
        make_clips(work, args.clips, args.seconds)
    dist.barrier()
    files = sorted(work.glob("*.wav"))
    single = Mesh(dp=1, tp=1, dp_rank=0, tp_rank=0, device=mesh.device)
    ok = True
    for model_name in ("w2v2-base", "wavlm-base-plus"):
        for bf16 in (False, True):
            os.environ["FADTK_TPU_BF16"] = "1" if bf16 else ""
            model = get_model(model_name)
            model.ensure_loaded()
            (mu, cov, n), launches, sharded_s = run(model, files, mesh, args.batch)
            (mu1, cov1, n1), _, single_s = run(model, files, single, args.batch)
            d_mu = np.abs(mu - mu1).max() / np.abs(mu1).max()
            d_cov = np.abs(cov - cov1).max() / np.abs(cov1).max()
            ok &= bool(n == n1 and d_mu <= RTOL[bf16] and d_cov <= RTOL[bf16])
            if mesh.rank == 0:
                print(f"{model_name} {'bf16' if bf16 else 'f32'} dp={mesh.dp} tp={mesh.tp}: "
                      f"n={n} (single {n1}); |mu| diff {d_mu:.3e}, |cov| diff {d_cov:.3e} of the "
                      f"largest single-device value (bound {RTOL[bf16]:g}); launches on rank 0: "
                      f"K1/K1b {launches[0]}, K2 {launches[1]}; sharded {sharded_s:.3f} s, "
                      f"single device {single_s:.3f} s", flush=True)
            del model
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(work, ignore_errors=True)
        print("ok" if ok else "FAILED", flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
