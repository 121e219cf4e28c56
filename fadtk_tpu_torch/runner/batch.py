"""Batch embedding orchestration.

Reference parity: ``cache_embedding_files`` (fadtk/fad_batch.py:25-48) — glob
the dataset, skip already-cached files, compute the rest.

As in ``fadtk_tpu.runner.batch``, one process owns the device; parallelism
comes from batched device inference, and host decode/resample runs on a small
thread pool, a window of files at a time, ahead of the embed step.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Union

import numpy as np

from ..models.base import EmbeddingModel
from ..utils import PathLike, dataset_files, get_cache_embedding_path, log
from . import profiling
from .fad import FrechetAudioDistance, atomic_save_npy


def cache_embedding_files_multi(
    models: Sequence[EmbeddingModel],
    directory: PathLike,
    workers: int = 8,
) -> None:
    """Cache embeddings for many models over one directory; the per-layer
    variants of one speech backbone (same ``weights_name``) share a single
    forward per file (``embed_all_layers``), the other models go through
    ``cache_embedding_files``.

    The reference re-runs the whole model for every layer variant
    (fadtk/package.py:30-31 iterates ~120 of them). A file whose caches all
    exist is skipped.
    """
    from collections import defaultdict

    from ..models.speech.family import SpeechEmbeddingModel

    groups: dict[str, list[SpeechEmbeddingModel]] = defaultdict(list)
    singles: list[EmbeddingModel] = []
    for m in models:
        if isinstance(m, SpeechEmbeddingModel):
            groups[m.weights_name()].append(m)
        else:
            singles.append(m)

    files = dataset_files(directory)
    for group in groups.values():
        todo = [f for f in files
                if any(not get_cache_embedding_path(m.cache_name, f).exists() for m in group)]
        if not todo:
            continue
        log.info(f"Caching embeddings for {directory} using "
                 f"{', '.join(m.name for m in group)} (shared backbone)")
        primary = group[0]
        primary.ensure_loaded()
        fad = FrechetAudioDistance(primary, audio_load_worker=workers, load_model=False)
        with profiling.traced(f"{primary.weights_name()} {directory}"):
            for f in todo:
                with profiling.stage("load_audio"):
                    wav = fad.load_audio(f)
                with profiling.stage("embed"):
                    all_layers = primary.embed_all_layers(np.asarray(wav))
                for m in group:
                    cache = get_cache_embedding_path(m.cache_name, f)
                    if not cache.exists():
                        atomic_save_npy(cache, all_layers[m.layer].astype(np.float16))

    for m in singles:
        log.info(f"Caching embeddings for {directory} using {m.name}")
        cache_embedding_files(directory, m, workers=workers)


def cache_embedding_files(
    files: Union[Sequence[Path], str, Path],
    ml: EmbeddingModel,
    workers: int = 8,
    **kwargs,
) -> None:
    """Compute and cache embeddings for all audio files (idempotent).

    ``workers`` controls host-side decode threads, not model replicas.
    """
    if isinstance(files, (str, Path)):
        files = dataset_files(files)

    files = [f for f in files if not get_cache_embedding_path(ml.cache_name, f).exists()]
    if len(files) == 0:
        log.info("All files already have embeddings, skipping.")
        return

    log.info(f"[Frechet Audio Distance] Loading {len(files)} audio files...")

    fad = FrechetAudioDistance(ml, **kwargs)

    def prepare(f: Path):
        try:
            with profiling.stage("load_audio"):
                return f, fad.load_audio(f)
        except Exception as e:
            log.error(f"Failed to load {f}: {e}")
            raise

    window = max(1, workers) * 4  # bound decoded-audio RAM while overlapping IO
    done = 0
    with profiling.traced(ml.name), ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        for i in range(0, len(files), window):
            if done:
                log.info(f"[{ml.name}] {done}/{len(files)} files embedded")
            group = list(ex.map(prepare, files[i : i + window]))
            todo = [
                (f, wav) for f, wav in group
                if not get_cache_embedding_path(ml.cache_name, f).exists()
            ]
            if not todo:
                continue
            with profiling.stage("embed"):
                embeds = ml.embed_batch([np.asarray(w) for _, w in todo])
            for (f, _), embd in zip(todo, embeds):
                if embd.dtype == np.float32:
                    embd = embd.astype(np.float16)
                atomic_save_npy(get_cache_embedding_path(ml.cache_name, f), embd)
            done += len(group)
