"""Split the gap between ``--device-pipeline`` and the cached path's statistics.

    python3 scripts/torch_pipeline_gap_probe.py [--device cpu|cuda] [--model w2v2-base]

Generates two datasets of 16 WAV clips (``chip_smoke.py``'s: 8 full 10 s, 8
ragged 2-9 s, every fourth at 44.1 kHz) in a temporary directory, loads the
model with random weights (f32) and prints, per dataset, the sources of the
difference between the device pipeline's (mu, cov) and the cached path's:

1. forward: the tp step's frames (file-order batches of 16) against the
   cached path's ``embed_batch`` frames (length buckets) for the same clips,
   both before the float16 cast;
2. rounding: how many float16 values of the two paths' frames differ;
3. accumulation: the pipeline's on-device float32 Welford against float64
   statistics of its own float16 frames;
4. cached host statistics: the cached path's per-file merge, which takes each
   file's mean in float16 (``np.mean`` of the float16 .npy, as the reference
   fadtk/utils.py:13-16 does), against float64 statistics of its own float16
   frames.

``split_gap`` is the measurement; ``chip_smoke.py`` calls it after its
w2v2-base f32 pipeline run, and tests/test_torch_device_pipeline.py at tiny
width on the CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _f64_stats(frames: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    x = np.concatenate(frames).astype(np.float64)
    return x.mean(axis=0), np.cov(x, rowvar=False)


def _cached_host_stats(frames: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """The cached path's statistics of per-file float16 arrays, as
    ``calculate_embd_statistics_online`` folds its .npy files."""
    from fadtk_tpu_torch.metric.stats import merge_partial_stats

    d = frames[0].shape[1]
    mu, s, n = np.zeros(d), np.zeros((d, d)), 0
    for e in frames:
        mu_b, s_b = np.mean(e, axis=0), np.cov(e, rowvar=False) * (e.shape[0] - 1)
        mu, s, n = merge_partial_stats(mu, s, n, mu_b, s_b, e.shape[0])
    return mu, s / (n - 1)


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def split_gap(model, dataset: Path, batch: int | None = None) -> dict:
    """Measure the four sources for ``model`` (a loaded float32 speech
    model) on the clips of ``dataset``; returns max abs differences."""
    from fadtk_tpu_torch.parallel import tp
    from fadtk_tpu_torch.runner.convert import ClipLoader
    from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device
    from fadtk_tpu_torch.utils import dataset_files, next_multiple

    files = dataset_files(dataset)
    clips = list(ClipLoader(model, workers=2).iter_clips(files))

    # The cached path: one embed_batch over the dataset, as the CLI's embed
    # stage makes it for 16 files; its pre-cast states are recorded.
    cached32: list[np.ndarray] = [None] * len(clips)
    real_forward = model._forward
    seen = []

    def forward(audio, num_valid, taps):
        states, n_frames = real_forward(audio, num_valid, taps)
        seen.append((states[0].float().cpu().numpy(), n_frames))
        return states, n_frames

    model._forward = forward
    try:
        cached16 = model.embed_batch(clips)
    finally:
        del model._forward
    # embed_batch groups the clips by bucket (first seen first), then runs
    # batches of MAX_BATCH in clip order: map each batch's rows back.
    groups: dict[int, list[int]] = {}
    for i, c in enumerate(clips):
        groups.setdefault(next_multiple(max(c.shape[0], 1), 10 * model.sr), []).append(i)
    batches = iter(seen)
    for items in groups.values():
        for g in range(0, len(items), model.MAX_BATCH):
            st, nf = next(batches)
            for j, i in enumerate(items[g:g + model.MAX_BATCH]):
                cached32[i] = st[j, :nf[j]]

    # The pipeline: its tp-step frames before the cast, then its statistics.
    pipe32: list[np.ndarray] = []
    real_tp = tp._tp_forward

    def tp_forward(*a, **kw):
        x, mask = real_tp(*a, **kw)
        xs, ms = x.float().cpu().numpy(), mask.cpu().numpy().astype(bool)
        pipe32.extend(xs[j][ms[j]] for j in range(xs.shape[0]) if ms[j].any())
        return x, mask

    tp._tp_forward = tp_forward
    try:
        mu_p, cov_p, n_p = dataset_stats_device(model, files, batch=batch, workers=2)
    finally:
        tp._tp_forward = real_tp
    pipe16 = [f.astype(np.float16) for f in pipe32]
    if [f.shape for f in pipe16] != [f.shape for f in cached16]:
        raise AssertionError("the two paths give other frame counts")

    mu_c, cov_c = _cached_host_stats(cached16)
    mu_p64, cov_p64 = _f64_stats(pipe16)
    mu_c64, cov_c64 = _f64_stats(cached16)
    scale = max(float(np.abs(np.concatenate(cached32)).max()), 1e-30)
    flips = sum(int((a != b).sum()) for a, b in zip(pipe16, cached16))
    values = sum(a.size for a in pipe16)
    return {
        "n": int(n_p),
        "forward_max_abs": max(_diff(a, b) for a, b in zip(pipe32, cached32)),
        "forward_rel": max(_diff(a, b) for a, b in zip(pipe32, cached32)) / scale,
        "f16_flips": flips, "f16_values": values,
        "f16_mu": _diff(mu_p64, mu_c64), "f16_cov": _diff(cov_p64, cov_c64),
        "accum_mu": _diff(mu_p, mu_p64), "accum_cov": _diff(cov_p, cov_p64),
        "cached_host_mu": _diff(mu_c, mu_c64), "cached_host_cov": _diff(cov_c, cov_c64),
        "total_mu": _diff(mu_p, mu_c), "total_cov": _diff(cov_p, cov_c),
        # the pipeline against exact statistics of the cached path's frames
        "exact_mu": _diff(mu_p, mu_c64), "exact_cov": _diff(cov_p, cov_c64),
    }


def format_gap(label: str, g: dict) -> str:
    return (f"{label}: n={g['n']}; total mu {g['total_mu']:.3e} cov {g['total_cov']:.3e} = "
            f"(1) forward max_abs {g['forward_max_abs']:.3e} (relative {g['forward_rel']:.3e}); "
            f"(2) f16 rounding {g['f16_flips']} of {g['f16_values']} values differ, moving "
            f"mu {g['f16_mu']:.3e} cov {g['f16_cov']:.3e}; (3) pipeline f32 accumulation mu "
            f"{g['accum_mu']:.3e} cov {g['accum_cov']:.3e}; (4) cached path's float16 "
            f"per-file means mu {g['cached_host_mu']:.3e} cov {g['cached_host_cov']:.3e}; pipeline vs "
            f"float64 statistics of the cached frames mu {g['exact_mu']:.3e} "
            f"cov {g['exact_cov']:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--model", default="w2v2-base")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card; pass --device cpu", file=sys.stderr)
        return 2
    os.environ["FADTK_TPU_TORCH_DEVICE"] = args.device
    os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
    os.environ.pop("FADTK_TPU_BF16", None)
    import chip_smoke
    from fadtk_tpu_torch.models.registry import get_model

    work = Path(tempfile.mkdtemp(prefix="pipeline_gap_"))
    os.environ["FADTK_TPU_CHECKPOINTS"] = str(work / "checkpoints")
    model = get_model(args.model)
    model.ensure_loaded()
    for i, name in enumerate(("baseline", "eval")):
        chip_smoke.make_dataset(work, name, chip_smoke.SEED + 1 + i)
        print(format_gap(f"{args.model} f32 {name} on {args.device}",
                         split_gap(model, work / name)), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
