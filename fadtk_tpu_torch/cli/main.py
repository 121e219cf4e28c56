"""`python -m fadtk_tpu_torch` — main CLI: FAD between two datasets with one model.

Same command line, CSV format and summary line as ``fadtk_tpu.cli.main``
(reference fadtk/__main__.py:9-74):

    python -m fadtk_tpu_torch <model> <baseline> <eval> [csv] [-w N] [--bf16]
                              [--inf [--seed S] | --indiv] [--device-scoring [--devices N]]
                              [--frechet-method eigh|reference|newton_schulz]
                              [--device-pipeline [--batch N] [--tp T] [--devices N]
                               [--multihost]]

``--inf`` extrapolates FAD-inf from seeded subsamples of the eval set and
``--indiv`` writes per-song scores to a CSV (runner/fad.py); both read the
embedding cache, on the host in float64 or, with ``--device-scoring``, on the
device (metric/device_scoring.py). ``--device-pipeline`` scores any model
without embedding caches (runner/device_pipeline.py). Over several GPUs
``--device-pipeline`` and ``--device-scoring`` run under ``torchrun``, one
process per GPU (parallel/mesh.py), and rank 0 reports. ``--multihost``
joins a job over several nodes (``torchrun --nnodes N``, parallel/multihost.py)
before anything touches the device and meshes ``--device-pipeline`` over all
its ranks, with each tp group on one node.
"""

from __future__ import annotations

import contextlib
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
                         "single-value results are printed to stdout; for --indiv "
                         "results go to 'fad-individual-results.csv'")
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
    ap.add_argument("--inf", action="store_true", help="Use FAD-inf extrapolation")
    ap.add_argument("--indiv", action="store_true",
                    help="Calculate FAD for individual songs and store the results "
                         "in the given file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the --inf subsampling (the reference is unseeded; "
                         "0 by default, for reproducibility)")
    ap.add_argument("--device-scoring", action="store_true",
                    help="run the FAD-inf sweep / per-song scoring on the device "
                         "(float32); several GPUs: run under torchrun, one process "
                         "per GPU, and the frames / songs split over them")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="plain-score fast path: embed and accumulate dataset "
                         "Gaussians on the device without writing per-file embedding "
                         ".npy caches; stats match the cached path to float32 "
                         "accumulation. Several GPUs: run under torchrun, one process "
                         "per GPU")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree for --device-pipeline: shard attention "
                         "heads / FFN columns over tp processes; the rest form the dp "
                         "axis. Must divide the number of processes")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of devices (processes) for --device-pipeline or "
                         "--device-scoring (default: all of the torchrun job; 1 "
                         "without torchrun)")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows per device step for --device-pipeline: clips for the "
                         "speech family (default 16 x dp), chunks or clips for the others "
                         "(default the family's preferred batch x dp)")
    ap.add_argument("--multihost", action="store_true",
                    help="multi-node mode for --device-pipeline: join the job's process "
                         "group (run under torchrun --nnodes N, the same command on every "
                         "node) and mesh over all its ranks; tp groups stay within a node")
    args = ap.parse_args()

    if args.device_pipeline and (args.inf or args.indiv):
        raise SystemExit("--device-pipeline supports plain scoring only "
                         "(--inf/--indiv read the embedding cache)")
    if args.multihost and not args.device_pipeline:
        raise SystemExit("--multihost requires --device-pipeline")
    if args.multihost:
        # Before anything touches the device: the process group picks the
        # rank's card (LOCAL_RANK) first.
        from ..parallel import multihost

        multihost.initialize()

    if args.bf16:
        os.environ["FADTK_TPU_BF16"] = "1"

    model = models[args.model]
    baseline, eval_ = args.baseline, args.eval

    if args.device_pipeline:
        _device_pipeline(args, model, baseline, eval_)
        return
    if args.tp != 1 or (args.devices is not None and not args.device_scoring):
        raise SystemExit("--tp/--devices require --device-pipeline "
                         "(--devices also composes with --device-scoring)")
    if args.device_scoring:
        _device_scoring(args, model, baseline, eval_)
    else:
        _score(args, model, baseline, eval_)


def _score(args, model, baseline, eval_, scoring_mesh=None) -> None:
    """Cache the embeddings of both datasets (rank 0 only under a scoring
    mesh, the others wait), then score in the mode the flags ask for."""
    import torch.distributed as dist

    # 1. Cache embeddings for both datasets.
    if scoring_mesh is None or scoring_mesh.rank == 0:
        for d in [baseline, eval_]:
            if Path(d).is_dir():
                cache_embedding_files(d, model, workers=args.workers)
    if scoring_mesh is not None and dist.is_initialized():
        dist.barrier()

    # 2. Score.
    fad = FrechetAudioDistance(
        model,
        audio_load_worker=args.workers,
        load_model=False,
        frechet_method=args.frechet_method,
        device_scoring=args.device_scoring,
        scoring_mesh=scoring_mesh,
    )
    report = scoring_mesh is None or scoring_mesh.rank == 0
    inf_r2 = None
    if args.inf:
        if not Path(eval_).is_dir():
            raise SystemExit("FAD-inf requires a directory as the evaluation dataset")
        result = fad.score_inf(baseline, sorted(Path(eval_).glob("*.*")), seed=args.seed)
        if report:
            print("FAD-inf Information:", result)
        score, inf_r2 = result.score, result.r2
    elif args.indiv:
        if not Path(eval_).is_dir():
            raise SystemExit("Individual FAD requires a directory as the evaluation dataset")
        csv_path = Path(args.csv or "fad-individual-results.csv")
        fad.score_individual(baseline, eval_, csv_path)
        if report:
            log.info(f"Individual FAD scores saved to {csv_path}")
        raise SystemExit(0)
    else:
        score = fad.score(baseline, eval_)
    if report:
        _report(args, model, baseline, eval_, score, inf_r2)


@contextlib.contextmanager
def _job_mesh(devices: int | None, tp: int = 1, multihost: bool = False):
    """This process's mesh over the torchrun job (or dp = tp = 1 without
    one); the process group that ``make_mesh`` or ``multihost.initialize``
    joined is left on exit."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh

    launched = multihost or not dist.is_initialized()
    if multihost:
        from ..parallel import multihost as mh

        mesh = mh.global_mesh(tp=tp)
    else:
        mesh = make_mesh(devices, tp=tp)
    try:
        yield mesh
    finally:
        if launched and dist.is_initialized():  # this CLI joined the group
            dist.destroy_process_group()


def _device_scoring(args, model, baseline, eval_) -> None:
    with _job_mesh(args.devices) as mesh:
        log.info(f"device scoring mesh: dp={mesh.dp} on {mesh.device}")
        _score(args, model, baseline, eval_, scoring_mesh=mesh)


def _device_pipeline(args, model, baseline, eval_) -> None:
    from ..runner.device_pipeline import score_datasets_device

    with _job_mesh(args.devices, tp=args.tp, multihost=args.multihost) as mesh:
        log.info(f"device pipeline mesh: dp={mesh.dp} x tp={mesh.tp} on {mesh.device}")
        try:
            score = score_datasets_device(model, baseline, eval_, mesh=mesh, batch=args.batch)
        except NotImplementedError as e:
            raise SystemExit(f"{model.name}: {e}")
        if mesh.rank == 0:
            _report(args, model, baseline, eval_, score, None)


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
