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
from ..utils import dataset_files, get_cache_embedding_path, log
from . import profiling
from .fad import FrechetAudioDistance, atomic_save_npy


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
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
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
    profiling.report()
