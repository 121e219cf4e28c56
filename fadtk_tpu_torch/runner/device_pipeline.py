"""Device-resident dataset scoring: audio -> embedding -> streaming covariance,
without writing per-file embedding .npy files.

The port of ``fadtk_tpu/runner/device_pipeline.py`` for the speech family
(w2v2, HuBERT, WavLM, MERT): the fast path for "score two directories" (the
reference always round-trips embeddings through the filesystem,
fadtk/fad.py:188-209). Clips are decoded and converted on host threads
(runner/convert.py), batched into one padding bucket per batch, embedded by
the (dp, tp) step of parallel/tp.py and folded into a Welford state that
stays on the device; the host fetches (mu, M2, n) once at the end and at
checkpoints (runner/resume.py), and finishes ``s / (n - 1)`` in float64.

Statistics equal the cached-embedding path's to float32 accumulation (this
path applies the same float16 round-trip to the frames before accumulating).

The other families' chunked / whole-clip dp pipeline (the JAX package's
``parallel/dp.py`` with each model's ``dp_spec`` / ``dp_whole_spec``) is not
ported yet: they raise ``NotImplementedError``.
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
from .convert import ClipLoader
from .fad import FrechetAudioDistance
from .resume import open_checkpoint, pipeline_ckpt_path


def _require_speech(model: EmbeddingModel) -> None:
    if not isinstance(model, SpeechEmbeddingModel):
        raise NotImplementedError(
            "--device-pipeline serves the speech family (w2v2, HuBERT, WavLM, MERT) only; "
            "the chunked / whole-clip dp pipeline the other families need is not ported to "
            "fadtk_tpu_torch yet: score without --device-pipeline (the cached-embedding path)"
        )


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

    ``checkpoint``: path for crash-resume snapshots of the running (mu, M2, n)
    + file cursor (runner/resume.py). When ``files`` is a dataset directory,
    it defaults to ``{dir}/stats/{model}/pipeline_ckpt.npz``; pass a path to
    override, or leave None (explicit file list) / set FADTK_TPU_CKPT=0 to
    disable. A resume with the same ``batch`` is bit-identical to an
    uninterrupted run. Under several ranks only rank 0 writes it.
    """
    _require_speech(model)
    if isinstance(files, (str, Path)):
        if checkpoint is None and Path(files).is_dir():
            checkpoint = pipeline_ckpt_path(files, model)
        files = dataset_files(files)
    model.ensure_loaded()
    if mesh is None:
        mesh = make_mesh()

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
    # ``batch`` re-batches identically.
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
    with torch.inference_mode():
        while True:
            clips = [
                c if c.shape[0] <= model.limit else c[: model.limit]
                for c in islice(clips_iter, batch)
            ]
            if not clips:
                break
            bucket = next_multiple(max(c.shape[0] for c in clips), BUCKET_SECONDS * model.sr)
            # Pad rows carry zero audio with num_valid = 1: they yield no
            # valid frame, and 1 keeps the normalisation's division finite.
            audio = np.zeros((batch, bucket), np.float32)
            num_valid = np.ones((batch,), np.int32)
            for j, c in enumerate(clips):
                audio[j, : c.shape[0]] = c
                num_valid[j] = c.shape[0]
            mu_b, cov_b, n_b = step(shard, audio, num_valid)
            # Zero-count partials fold in exactly (the max(n, 1) guards).
            state = merge_partial_stats_device(state, mu_b, cov_b, n_b, b_is_cov=True)
            files_done += len(clips)
            if ckpt is not None and ckpt.due(files_done):
                # One host fetch syncs the chain up to here; state covers
                # files[:files_done] exactly.
                ckpt.save(tuple(x.cpu().numpy() for x in state), files_done)

    if ckpt is not None:
        ckpt.finalize()
    if state is None:
        d = model.num_features
        return np.zeros(d), np.zeros((d, d)), 0
    mu = state[0].cpu().numpy().astype(np.float64)
    s = state[1].cpu().numpy().astype(np.float64)
    n = int(state[2].item())
    if n < 2:
        return mu, np.zeros_like(s), n
    return mu, s / (n - 1), n


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

    _require_speech(model)
    fad = FrechetAudioDistance(model, load_model=True)
    if Path(str(baseline)).is_dir():
        mu1, cov1, _ = dataset_stats_device(model, baseline, mesh=mesh, batch=batch)
    else:
        mu1, cov1 = fad.load_stats(baseline)
    mu2, cov2, _ = dataset_stats_device(model, eval_dir, mesh=mesh, batch=batch)
    return frechet_distance(mu1, cov1, mu2, cov2)
