"""`python -m fadtk_tpu_torch` — main CLI: FAD between two datasets with one model.

Same command line, CSV format and summary line as ``fadtk_tpu.cli.main``
(reference fadtk/__main__.py:9-74):

    python -m fadtk_tpu_torch <model> <baseline> <eval> [csv] [-w N] [--bf16]
                              [--frechet-method eigh|reference|newton_schulz]
                              [--device-pipeline [--batch N] [--tp T] [--devices N]]

``--device-pipeline`` scores the speech family without embedding caches
(runner/device_pipeline.py); over several GPUs it runs under ``torchrun``,
one process per GPU (parallel/mesh.py), and rank 0 reports. ``--inf``,
``--indiv``, ``--device-scoring`` and ``--multihost`` are accepted and exit
with a message: they are not ported yet.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from pathlib import Path

from ..models.registry import get_all_models
from ..runner.batch import cache_embedding_files
from ..runner.fad import FrechetAudioDistance
from ..utils import log


def main() -> None:
    models = {m.name: m for m in get_all_models()}

    ap = ArgumentParser(prog="python -m fadtk_tpu_torch")
    ap.add_argument("model", type=str, choices=list(models.keys()),
                    help="The embedding model to use")
    ap.add_argument("baseline", type=str, help="The baseline dataset")
    ap.add_argument("eval", type=str, help="The directory to evaluate against")
    ap.add_argument("csv", type=str, nargs="?",
                    help="The CSV file to append results to. If not supplied, "
                         "single-value results are printed to stdout")
    ap.add_argument("-w", "--workers", type=int, default=8)
    ap.add_argument("-s", "--sox-path", type=str, default="/usr/bin/sox",
                    help="(accepted for reference compatibility; unused)")
    ap.add_argument("--frechet-method", type=str, default="eigh",
                    choices=["eigh", "reference", "newton_schulz"],
                    help="sqrtm evaluator: f64 eigh (default), the reference's "
                         "bit-faithful scipy dual computation, or device f32 NS")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 throughput mode: model weights/compute run in "
                         "bfloat16 and attention takes the flash kernel. "
                         "Embeddings differ slightly from float32, so "
                         "caches/stats/results key under '<model>-bf16'. "
                         "Scoring math stays float64 on host.")
    ap.add_argument("--seed", type=int, default=0, help="(for --inf; not ported yet)")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="plain-score fast path for the speech family: embed and "
                         "accumulate dataset Gaussians on the device without writing "
                         "per-file embedding .npy caches; stats match the cached path "
                         "to float32 accumulation. Several GPUs: run under torchrun, "
                         "one process per GPU")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for --device-pipeline: shard attention "
                         "heads / FFN columns over tp processes; the rest form the dp "
                         "axis. Must divide the number of processes")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of devices (processes) for --device-pipeline "
                         "(default: all of the torchrun job; 1 without torchrun)")
    ap.add_argument("--batch", type=int, default=None,
                    help="clips per device step for --device-pipeline (default 16 x dp)")
    not_ported = {
        "inf": ap.add_argument("--inf", action="store_true", help="(not ported yet)"),
        "indiv": ap.add_argument("--indiv", action="store_true", help="(not ported yet)"),
        "device_scoring": ap.add_argument(
            "--device-scoring", action="store_true", help="(not ported yet)"),
        "multihost": ap.add_argument("--multihost", action="store_true", help="(not ported yet)"),
    }
    args = ap.parse_args()

    if args.device_pipeline and (args.inf or args.indiv):
        raise SystemExit("--device-pipeline supports plain scoring only "
                         "(--inf/--indiv read the embedding cache)")
    for dest, action in not_ported.items():
        if getattr(args, dest) != action.default:
            raise SystemExit(
                f"{action.option_strings[0]} is not ported to fadtk_tpu_torch yet; "
                "use `python -m fadtk_tpu` for it"
            )

    if args.bf16:
        os.environ["FADTK_TPU_BF16"] = "1"

    model = models[args.model]
    baseline, eval_ = args.baseline, args.eval

    if args.device_pipeline:
        _device_pipeline(args, model, baseline, eval_)
        return
    if args.tp != 1 or args.devices is not None:
        raise SystemExit("--tp/--devices require --device-pipeline")

    # 1. Cache embeddings for both datasets.
    for d in [baseline, eval_]:
        if Path(d).is_dir():
            cache_embedding_files(d, model, workers=args.workers)

    # 2. Score.
    fad = FrechetAudioDistance(
        model,
        audio_load_worker=args.workers,
        load_model=False,
        frechet_method=args.frechet_method,
    )
    score = fad.score(baseline, eval_)
    _report(args, model, baseline, eval_, score, None)


def _device_pipeline(args, model, baseline, eval_) -> None:
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh
    from ..runner.device_pipeline import score_datasets_device

    launched = not dist.is_initialized()
    mesh = make_mesh(args.devices, tp=args.tp)
    try:
        log.info(f"device pipeline mesh: dp={mesh.dp} x tp={mesh.tp} on {mesh.device}")
        try:
            score = score_datasets_device(model, baseline, eval_, mesh=mesh, batch=args.batch)
        except NotImplementedError as e:
            raise SystemExit(f"{model.name}: {e}")
        if mesh.rank == 0:
            _report(args, model, baseline, eval_, score, None)
    finally:
        if launched and dist.is_initialized():  # make_mesh joined torchrun's group
            dist.destroy_process_group()


def _report(args, model, baseline, eval_, score, inf_r2) -> None:
    """Same summary + CSV append format as the reference
    (fadtk/__main__.py:60-70)."""
    log.info("FAD computed.")
    if args.csv:
        csv = Path(args.csv)
        csv.parent.mkdir(parents=True, exist_ok=True)
        if not csv.is_file():
            csv.write_text("model,baseline,eval,score,inf_r2,time\n")
        with open(csv, "a") as f:
            # cache_name == name except in --bf16 mode, where rows are
            # self-describing ('<model>-bf16': different numerics).
            f.write(f"{model.cache_name},{baseline},{eval_},{score},{inf_r2},{time.time()}\n")
        log.info(f"FAD score appended to {args.csv}")

    log.info(f"The FAD {model.cache_name} score between {baseline} and {eval_} is: {score}")


if __name__ == "__main__":
    main()
