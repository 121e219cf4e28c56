"""Device-resident dataset scoring: audio -> embedding -> streaming covariance,
without writing per-file embedding .npy files.

The port of ``fadtk_tpu/runner/device_pipeline.py``: the fast path for
"score two directories" (the reference always round-trips embeddings through
the filesystem, fadtk/fad.py:188-209). Clips are decoded and converted on
host threads (runner/convert.py), embedded on the device and folded into a
Welford state that stays there; the host fetches (mu, M2, n) once at the end
and at checkpoints (runner/resume.py), and finishes ``s / (n - 1)`` in
float64. Two device paths cover the zoo:

- the speech family (w2v2, HuBERT, WavLM, MERT): one padding bucket per
  batch through the (dp, tp) step of parallel/tp.py. The pass processes its
  files stably sorted by padding bucket, longest first, with lengths read
  from WAV headers (``processing_order``), so a batch holds clips of like
  length; a file list of one bucket keeps its order;
- every other family through the generic pipelines of parallel/dp.py, via
  the model's ``dp_spec()`` (fixed-window chunks: VGGish, CLAP, CDPAM, DAC,
  EnCodec-48k, Whisper) or ``dp_whole_spec()`` (whole clips at exact length,
  grouped by length: encodec-emb 24k). Each spec's forward is the one the
  cached path calls, so the same kernels launch (K3 in Whisper's and CLAP's
  frontends, K4 in encodec-emb under ``FADTK_TPU_FUSED_RESNET``).

Statistics equal the cached-embedding path's to float32 accumulation (this
path applies the same float16 round-trip to the frames before accumulating).
"""

from __future__ import annotations

from itertools import islice
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..metric.stats import merge_partial_stats_device
from ..models.base import EmbeddingModel
from ..models.speech.family import BUCKET_SECONDS, SpeechEmbeddingModel
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.tp import make_sharded_eval_step, shard_speech_params
from ..utils import PathLike, dataset_files, next_multiple
from . import profiling
from .convert import ClipLoader, clip_samples
from .fad import FrechetAudioDistance
from .resume import open_checkpoint, pipeline_ckpt_path


def dataset_stats_device(
    model: EmbeddingModel,
    files: Sequence[Path] | PathLike,
    mesh: Mesh | None = None,
    batch: int | None = None,
    workers: int = 8,
    checkpoint: PathLike | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """(mu, cov, n_frames) of a dataset, computed on the device.

    ``mesh``: this rank's (dp, tp) mesh (parallel/mesh.py); None = a single
    process on one device. ``batch`` (default 16·dp) clips go to each step
    and must divide by dp; every rank of the job walks the same files and
    embeds its dp slice of each batch.

    On the speech path the files are processed in ``processing_order``:
    stably sorted by the padding bucket their header length falls in,
    longest first, files without a WAV header last in their given order.
    The lengths only order the pass; each batch is padded to its decoded
    clips, so a wrong or missing header costs padding, never correctness.

    ``checkpoint``: path for crash-resume snapshots of the running (mu, M2, n)
    + file cursor (runner/resume.py). When ``files`` is a dataset directory,
    it defaults to ``{dir}/stats/{model}/pipeline_ckpt.npz``; pass a path to
    override, or leave None (explicit file list) / set FADTK_TPU_CKPT=0 to
    disable. On the speech path a resume with the same ``batch`` is
    bit-identical to an uninterrupted run; the chunked paths resume equal to
    float32 accumulation (the batch packing differs). The checkpoint's
    fingerprint is taken over the processing order and its cursor counts
    files of that order; a resume probes the same headers and gets the same
    order, and a checkpoint of another order is ignored. Under several ranks
    only rank 0 writes it (every rank probes the same headers, so all agree
    on the order).

    The speech family takes the bucketed (dp, tp) step; every other family
    its ``dp_spec`` or ``dp_whole_spec`` (``_dataset_stats_device_chunked``).
    Under tracing (runner/profiling.py) the pass records its spans and
    counters; ``FADTK_TPU_TRACE`` also writes its trace.
    """
    with profiling.traced("dataset_stats_device"):
        return _dataset_stats_device(model, files, mesh, batch, workers, checkpoint)


def _bucket(model: SpeechEmbeddingModel, n: int) -> int:
    """The padded length of a speech batch whose longest clip has ``n``
    samples."""
    return next_multiple(min(n, model.limit), int(BUCKET_SECONDS * model.sr))


def processing_order(model: SpeechEmbeddingModel, files: Sequence[Path]) -> list[Path]:
    """``files`` in the speech path's processing order: stably sorted by
    the padding bucket of their clip's length (``convert.clip_samples``, WAV
    headers only), longest first. Each batch then pads its clips to a bucket
    near their own length. Longest first, the card has the most work queued
    behind each loader window after the first, and the largest batch, which
    sets the pass's peak memory, comes first. Files of one bucket, and files
    no header measures (put after all others), keep their order; a list of
    one bucket is returned as it is. Counts ``pipeline.order_probed`` (files
    measured) and ``pipeline.order_moved`` (files at another position than
    given)."""
    lengths = [clip_samples(model, f) for f in files]
    order = sorted(range(len(files)), key=lambda i: (
        (1, 0) if lengths[i] is None else (0, -_bucket(model, lengths[i]))))
    profiling.count("pipeline.order_probed", sum(n is not None for n in lengths))
    profiling.count("pipeline.order_moved", sum(i != j for j, i in enumerate(order)))
    return [files[i] for i in order]


def _dataset_stats_device(model, files, mesh, batch, workers, checkpoint):
    if isinstance(files, (str, Path)):
        if checkpoint is None and Path(files).is_dir():
            checkpoint = pipeline_ckpt_path(files, model)
        files = dataset_files(files)
    model.ensure_loaded()
    if mesh is None:
        mesh = make_mesh()
    if not isinstance(model, SpeechEmbeddingModel):
        return _dataset_stats_device_chunked(model, files, mesh, batch=batch, workers=workers,
                                             checkpoint=checkpoint)

    dp = mesh.dp
    if batch is None:
        batch = 16 * dp
    if batch % dp:
        raise ValueError(f"batch {batch} must divide dp={dp}")

    step = make_sharded_eval_step(model.cfg, model.module, mesh, model.layer)
    shard = shard_speech_params(model.module, mesh)
    loader = ClipLoader(model, workers=workers)

    # Crash-resume: snapshots happen only at batch boundaries, which here are
    # file boundaries (one clip = one row), so a resumed run with the same
    # ``batch`` re-batches identically. The fingerprint and the cursor are
    # over the processing order.
    files = processing_order(model, files)
    ckpt, host_state, files_done = open_checkpoint(checkpoint, model, files)
    if ckpt is not None and mesh.rank != 0:
        ckpt = None  # every rank holds the same state; rank 0 writes it

    # The running (mu, M2, n) stays on the device: the loop never fetches
    # per-batch partials, so the host decodes the next batch while the card
    # runs this one.
    state = None
    if host_state is not None:
        state = tuple(torch.from_numpy(x).to(mesh.device) for x in host_state)
    clips_iter = loader.iter_clips(files[files_done:])
    profiling.steps_begin(mesh.device)
    with torch.inference_mode():
        while True:
            with profiling.stage("pipeline.wait_clips"):
                clips = [
                    c if c.shape[0] <= model.limit else c[: model.limit]
                    for c in islice(clips_iter, batch)
                ]
            if not clips:
                break
            with profiling.stage("pipeline.pad"):
                bucket = _bucket(model, max(c.shape[0] for c in clips))
                # Pad rows carry zero audio with num_valid = 1: they yield no
                # valid frame, and 1 keeps the normalisation's division finite.
                audio = np.zeros((batch, bucket), np.float32)
                num_valid = np.ones((batch,), np.int32)
                for j, c in enumerate(clips):
                    audio[j, : c.shape[0]] = c
                    num_valid[j] = c.shape[0]
            # num_valid marks one sample of each pad row valid
            profiling.count_batch(batch, batch - len(clips), bucket, int(num_valid.sum()))
            with profiling.stage("pipeline.step"):
                mu_b, cov_b, n_b = step(shard, audio, num_valid)
            # Zero-count partials fold in exactly (the max(n, 1) guards).
            with profiling.stage("pipeline.merge"):
                state = merge_partial_stats_device(state, mu_b, cov_b, n_b, b_is_cov=True)
            profiling.step_end(mesh.device)
            files_done += len(clips)
            if ckpt is not None and ckpt.due(files_done):
                # One host fetch syncs the chain up to here; state covers
                # files[:files_done] exactly.
                with profiling.stage("pipeline.checkpoint"):
                    ckpt.save(tuple(x.cpu().numpy() for x in state), files_done)

    if ckpt is not None:
        ckpt.finalize()
    if state is None:
        d = model.num_features
        return np.zeros(d), np.zeros((d, d)), 0
    with profiling.stage("pipeline.fetch"):
        mu = state[0].cpu().numpy().astype(np.float64)
        s = state[1].cpu().numpy().astype(np.float64)
        n = int(state[2].item())
    profiling.read_steps()
    if n < 2:
        return mu, np.zeros_like(s), n
    return mu, s / (n - 1), n


def _model_dp_specs(model: EmbeddingModel):
    """(dp_spec, dp_whole_spec) memoised on the model instance, as in the JAX
    package (whose dp step executables live on the spec): one spec serves
    every dataset pass of the model. Safe to latch: ``ensure_loaded`` is
    idempotent and the bf16 mode is latched with the weights."""
    cached = getattr(model, "_dp_specs_cache", None)
    if cached is None:
        spec = model.dp_spec()
        whole = model.dp_whole_spec() if spec is None else None
        cached = (spec, whole)
        model._dp_specs_cache = cached
    return cached


def _dataset_stats_device_chunked(
    model: EmbeddingModel,
    files: Sequence[Path],
    mesh: Mesh,
    batch: int | None = None,
    workers: int = 8,
    checkpoint: PathLike | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """The generic chunked / whole-clip pipelines (parallel/dp.py) for the
    non-speech families."""
    import torch.distributed as dist

    from ..parallel.dp import dp_chunk_dataset_stats, dp_whole_clip_dataset_stats

    spec, whole = _model_dp_specs(model)
    if spec is None and whole is None:
        raise NotImplementedError(
            f"{model.name} has neither a static-window nor a whole-clip dp path; use the "
            "cached-embedding path")

    # Crash-resume: saves follow a flush of the pending chunks, so the
    # snapshot covers files[:cursor] exactly.
    ckpt, host_state, files_done = open_checkpoint(checkpoint, model, files)
    if dist.is_initialized() and dist.get_world_size() > 1:
        # Every rank flushes and merges at a checkpoint, so every rank must
        # see it due at the same file: the cadence counts files only. And no
        # rank starts (rank 0 may soon write) before all have read the
        # resume point.
        if ckpt is not None:
            ckpt.every_seconds = float("inf")
        dist.barrier()
    clips = ClipLoader(model, workers=workers).iter_clips(files[files_done:])
    run = dp_chunk_dataset_stats if spec is not None else dp_whole_clip_dataset_stats
    out = run(spec if spec is not None else whole, clips, mesh, batch=batch,
              ckpt=ckpt, files_done=files_done, initial_state=host_state)
    if ckpt is not None and mesh.rank == 0:
        ckpt.finalize()
    return out


def score_datasets_device(
    model: EmbeddingModel,
    baseline: PathLike,
    eval_dir: PathLike,
    mesh: Mesh | None = None,
    batch: int | None = None,
) -> float:
    """FAD between two datasets with both Gaussians computed on the device;
    the baseline may also be a stats source (npz/name) resolved the usual
    way."""
    from ..metric.frechet import frechet_distance

    fad = FrechetAudioDistance(model, load_model=True)
    if Path(str(baseline)).is_dir():
        mu1, cov1, _ = dataset_stats_device(model, baseline, mesh=mesh, batch=batch)
    else:
        mu1, cov1 = fad.load_stats(baseline)
    mu2, cov2, _ = dataset_stats_device(model, eval_dir, mesh=mesh, batch=batch)
    return frechet_distance(mu1, cov1, mu2, cov2)
