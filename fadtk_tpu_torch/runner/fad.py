"""The metric engine: audio conversion cache, embedding cache I/O, statistics
loading and plain FAD scoring.

API parity with the reference's ``FrechetAudioDistance`` (fadtk/fad.py:123-302)
and with ``fadtk_tpu.runner.fad``: ``load_audio``, ``cache_embedding_file``,
``read_embedding_file``, ``load_embeddings``, ``load_stats``, ``score`` — same
cache layout, same stats resolution order. Audio conversion is host-only:
decode (audio/decode.py), mean downmix, the Kaiser-sinc resampler
(dsp/resample.py), 16-bit PCM.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np

from ..metric.frechet import frechet_distance
from ..metric.stats import calculate_embd_statistics_online
from ..models.base import EmbeddingModel
from ..utils import (
    PathLike,
    dataset_files,
    get_cache_embedding_path,
    get_convert_cache_path,
    get_stats_cache_dir,
    log,
)


def atomic_save_npy(path: Path, array: np.ndarray) -> None:
    """np.save via temp-file + rename: concurrent cache writers can only race
    to an identical, complete file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
    np.save(tmp, array)
    os.replace(tmp, path)


def _shipped_stats_dirs() -> list[Path]:
    """Directories of packaged baseline statistics (.npz): ``FADTK_TPU_BASELINES``
    (os.pathsep-separated) first, then the port's own ``baselines/`` (the key
    format '{model}.mu'/'{model}.cov' is the JAX package's,
    fadtk/package.py:34-42, so its files can be copied or named there)."""
    dirs = [
        Path(d)
        for d in os.environ.get("FADTK_TPU_BASELINES", "").split(os.pathsep)
        if d
    ]
    dirs.append(Path(__file__).resolve().parents[1] / "baselines")
    return dirs


def convert_audio(f: PathLike, sr: int) -> np.ndarray:
    """Decode, mean downmix to mono, Kaiser-resample to ``sr`` and quantize:
    the int16 content of the convert cache's wav for ``f`` (parity:
    reference fadtk/fad.py:145-160)."""
    from ..audio.decode import decode_audio
    from ..audio.wavio import float_to_int16
    from ..dsp.resample import resample_kaiser

    x, sr_orig = decode_audio(f)  # (channels, n) float32
    mono = np.mean(x, axis=0)  # parity: fadtk/fad.py:150
    return float_to_int16(resample_kaiser(mono, sr_orig, sr))


class FrechetAudioDistance:
    def __init__(
        self,
        ml: EmbeddingModel,
        audio_load_worker: int = 8,
        load_model: bool = True,
        frechet_method: str = "eigh",
    ):
        self.ml = ml
        self.audio_load_worker = audio_load_worker
        self.frechet_method = frechet_method
        if load_model:
            self.ml.ensure_loaded()

    # ------------------------------------------------------------------ #
    # Audio conversion cache
    # ------------------------------------------------------------------ #

    def load_audio(self, f: PathLike) -> np.ndarray:
        """Convert any input file to a cached mono 16-bit wav at the model's
        sample rate, then hand it to the model's ``load_wav``.

        Parity: reference fadtk/fad.py:139-186 — decode, mean downmix to mono,
        Kaiser-windowed sinc resample with width=64,
        rolloff=0.9475937167399596, beta=14.769656459379492, save as 16-bit PCM.
        """
        f = Path(f)
        new = get_convert_cache_path(self.ml.sr, f)

        if not new.exists():
            from ..audio.wavio import write_wav_int16

            write_wav_int16(new, convert_audio(f, self.ml.sr), self.ml.sr)

        return self.ml.load_wav(new)

    # ------------------------------------------------------------------ #
    # Embedding cache
    # ------------------------------------------------------------------ #

    def cache_embedding_file(self, audio_path: PathLike) -> None:
        """Compute and cache the embedding of one audio file (idempotent).

        Parity: reference fadtk/fad.py:188-201.
        """
        from . import profiling

        cache = get_cache_embedding_path(self.ml.cache_name, audio_path)
        if cache.exists():
            return
        with profiling.stage("load_audio"):
            wav_data = self.load_audio(audio_path)
        with profiling.stage("embed"):
            embd = self.ml.get_embedding(wav_data)
        atomic_save_npy(cache, embd)

    def read_embedding_file(self, audio_path: PathLike) -> np.ndarray:
        """Parity: reference fadtk/fad.py:203-209."""
        cache = get_cache_embedding_path(self.ml.cache_name, audio_path)
        assert cache.exists(), (
            f"Embedding file {cache} does not exist, please run cache_embedding_file first."
        )
        return np.load(cache)

    def load_embeddings(self, dir: PathLike, max_count: int = -1, concat: bool = True):
        """Parity: reference fadtk/fad.py:211-218."""
        files = dataset_files(dir)
        log.info(f"Loading {len(files)} audio files from {dir}...")
        return self._load_embeddings(files, max_count=max_count, concat=concat)

    def _load_embeddings(
        self, files: Sequence[Path], max_count: int = -1, concat: bool = True
    ):
        """Parity: reference fadtk/fad.py:220-243 (threaded read, max_count early
        stop by cumulative frames)."""
        if len(files) == 0:
            raise ValueError("No files provided")

        if max_count == -1:
            with ThreadPoolExecutor(max_workers=self.audio_load_worker) as ex:
                embd_lst = list(ex.map(self.read_embedding_file, files))
        else:
            total_len = 0
            embd_lst = []
            for f in files:
                embd_lst.append(self.read_embedding_file(f))
                total_len += embd_lst[-1].shape[0]
                if total_len > max_count:
                    break

        if concat:
            return np.concatenate(embd_lst, axis=0)
        return embd_lst, files

    # ------------------------------------------------------------------ #
    # Statistics
    # ------------------------------------------------------------------ #

    def load_stats(self, path: PathLike) -> tuple[np.ndarray, np.ndarray]:
        """Load (mu, cov) with the reference's resolution order
        (fadtk/fad.py:245-290):

        1. a string name resolving to a shipped baseline npz;
        2. an .npz file keyed '{model}.mu' / '{model}.cov';
        3. a dataset dir with cached stats/{model}/mu.npy, cov.npy;
        4. a dataset dir of embeddings -> online statistics, then cache them.
        """
        if isinstance(path, str):
            for d in _shipped_stats_dirs():
                stats = d / (path.lower() + ".npz")
                if stats.exists():
                    path = stats
                    break

        path = Path(path)

        if path.is_file():
            log.info(f"Loading embedding statistics from {path}...")
            with np.load(path) as data:
                mu_key, cov_key = f"{self.ml.name}.mu", f"{self.ml.name}.cov"
                if mu_key not in data or cov_key not in data:
                    raise ValueError(
                        f"FAD statistics file {path} doesn't contain data for model {self.ml.name}"
                    )
                return data[mu_key], data[cov_key]

        # bf16-mode embeddings live (and cache their stats) under a distinct
        # `<model>-bf16` name; packaged .npz baselines above keep the plain
        # model key (they are the reference's float32 statistics).
        cache_dir = get_stats_cache_dir(path, self.ml.cache_name)
        emb_dir = path / "embeddings" / self.ml.cache_name
        # Keyed on mu.npy, not the directory: a directory without final
        # statistics in it (an interrupted run) must not count as cached.
        if (cache_dir / "mu.npy").exists():
            log.info(f"Embedding statistics is already cached for {path}, loading...")
            return np.load(cache_dir / "mu.npy"), np.load(cache_dir / "cov.npy")

        if not path.is_dir():
            log.error(f"The dataset you want to use ({path}) is not a directory nor a file.")
            raise SystemExit(1)

        log.info(f"Loading embedding files from {path}...")
        mu, cov = calculate_embd_statistics_online(sorted(emb_dir.glob("*.npy")))
        log.info("> Embeddings statistics calculated.")

        # cov first, mu last, both atomic: the cache-present check above keys
        # on mu.npy, so its presence must imply a complete (mu, cov) pair even
        # across a crash between the two writes.
        atomic_save_npy(cache_dir / "cov.npy", cov)
        atomic_save_npy(cache_dir / "mu.npy", mu)
        return mu, cov

    # ------------------------------------------------------------------ #
    # Scoring
    # ------------------------------------------------------------------ #

    def score(self, baseline: PathLike, eval: PathLike) -> float:
        """Plain FAD between two datasets (parity: fadtk/fad.py:292-302)."""
        mu_bg, cov_bg = self.load_stats(baseline)
        mu_ev, cov_ev = self.load_stats(eval)
        return frechet_distance(
            mu_bg, cov_bg, mu_ev, cov_ev, method=self.frechet_method, device=self.ml.device
        )
