"""The metric engine: audio conversion cache, embedding cache I/O, statistics
loading, and the three scoring modes (plain FAD, FAD-inf, per-song).

API parity with the reference's ``FrechetAudioDistance`` (fadtk/fad.py:123-395)
and with ``fadtk_tpu.runner.fad``: ``load_audio``, ``cache_embedding_file``,
``read_embedding_file``, ``load_embeddings``, ``load_stats``, ``score``,
``score_inf``, ``score_individual`` — same cache layout, same stats resolution
order, same CSV conventions. Audio conversion is host-only: decode
(audio/decode.py), mean downmix, the Kaiser-sinc resampler (dsp/resample.py),
16-bit PCM. FAD-inf subsampling takes an explicit seed (the reference's
np.random.choice at fadtk/fad.py:333 is unseeded); with ``device_scoring``
the FAD-inf sweep and per-song scoring run on the device
(metric/device_scoring.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np

from ..metric.frechet import FrechetBaseline, frechet_distance
from ..metric.stats import calc_embd_statistics, calculate_embd_statistics_online
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


class FADInfResults(NamedTuple):
    """Parity: reference fadtk/fad.py:35-39."""

    score: float
    slope: float
    r2: float
    points: list[tuple[int, float]]


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
    from .profiling import stage

    with stage("loader.decode"):
        x, sr_orig = decode_audio(f)  # (channels, n) float32
        mono = np.mean(x, axis=0)  # parity: fadtk/fad.py:150
    with stage("loader.resample"):
        y = resample_kaiser(mono, sr_orig, sr)
    with stage("loader.quantise"):
        return float_to_int16(y)


class FrechetAudioDistance:
    def __init__(
        self,
        ml: EmbeddingModel,
        audio_load_worker: int = 8,
        load_model: bool = True,
        frechet_method: str = "eigh",
        device_scoring: bool = False,
        scoring_mesh=None,
    ):
        """``device_scoring=True`` runs the FAD-inf sweep and per-song scoring
        on the device (float32; ~1e-3 relative to the host float64 parity
        path, metric/device_scoring.py). ``scoring_mesh``: an optional
        ``parallel.mesh.Mesh`` for those loops, whose dp ranks split the
        FAD-inf frame matrix and the per-song batches (per-song scores equal
        a single device's; the sweep is statistically equivalent)."""
        self.ml = ml
        self.audio_load_worker = audio_load_worker
        self.frechet_method = frechet_method
        self.device_scoring = device_scoring
        self.scoring_mesh = scoring_mesh
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

    def score_inf(
        self,
        baseline: PathLike,
        eval_files: list[Path],
        steps: int = 25,
        min_n: int = 500,
        seed: int = 0,
    ) -> FADInfResults:
        """Bias-corrected FAD-inf extrapolation (parity: fadtk/fad.py:304-351;
        same ns grid, same with-replacement subsampling, same 1/n linear fit,
        seeded: ``np.random.RandomState(seed)``, as the JAX package draws)."""
        log.info(f"Calculating FAD-inf for {self.ml.name}...")
        mu_base, cov_base = self.load_stats(baseline)

        if all(f.suffix == ".npy" for f in eval_files):
            embeds = np.concatenate([np.load(f) for f in eval_files], axis=0)
        else:
            embeds = self._load_embeddings(list(eval_files), concat=True)

        if self.device_scoring:
            from ..metric.device_scoring import fad_inf_device

            return FADInfResults(*fad_inf_device(
                mu_base, cov_base, embeds, steps=steps, min_n=min_n, seed=seed,
                mesh=self.scoring_mesh))

        max_n = len(embeds)
        ns = [int(n) for n in np.linspace(min_n, max_n, steps)]
        rng = np.random.RandomState(seed)
        # Factor sqrtm(C_base) once across the whole sweep (eigh path).
        baseline_factor = (
            FrechetBaseline(mu_base, cov_base) if self.frechet_method == "eigh" else None
        )

        results: list[tuple[int, float]] = []
        for n in ns:
            indices = rng.choice(embeds.shape[0], size=n, replace=True)
            mu_ev, cov_ev = calc_embd_statistics(embeds[indices])
            if baseline_factor is not None:
                fad = baseline_factor.distance(mu_ev, cov_ev)
            else:
                fad = frechet_distance(mu_base, cov_base, mu_ev, cov_ev,
                                       method=self.frechet_method, device=self.ml.device)
            results.append((n, fad))

        ys = np.array([r[1] for r in results])
        xs = 1.0 / np.array(ns)
        slope, intercept = np.polyfit(xs, ys, 1)
        r2 = 1 - np.sum((ys - (slope * xs + intercept)) ** 2) / np.sum((ys - np.mean(ys)) ** 2)
        return FADInfResults(score=float(intercept), slope=float(slope), r2=float(r2),
                             points=results)

    def score_individual(self, baseline: PathLike, eval_dir: PathLike,
                         csv_name: PathLike) -> Path:
        """Per-song FAD scores written to a CSV sorted by |score| ascending.

        Parity: reference fadtk/fad.py:353-395 — default path
        data/fad-individual/{model}/{csv} for a str name, skip-if-exists,
        per-file errors dropped, comma fields sanitized to '_'. With
        ``device_scoring`` the songs stream through one ``PerSongScorer`` in
        windows of 256 files; under a dp mesh every rank scores and rank 0
        writes the CSV.
        """
        csv = Path(csv_name)
        if isinstance(csv_name, str):
            csv = Path("data") / "fad-individual" / self.ml.cache_name / csv_name
        if csv.exists():
            log.info(f"CSV file {csv} already exists, exiting...")
            return csv

        mu, cov = self.load_stats(baseline)
        files = dataset_files(eval_dir)
        if self.device_scoring:
            pairs = self._score_individual_device(mu, cov, files)
        else:
            pairs = self._score_individual_host(mu, cov, files)

        pairs.sort(key=lambda x: abs(x[1]))
        if self.scoring_mesh is None or self.scoring_mesh.rank == 0:
            csv.parent.mkdir(parents=True, exist_ok=True)
            csv.write_text("\n".join(
                ",".join(str(x).replace(",", "_") for x in row) for row in pairs))
        return csv

    def _score_individual_device(self, mu, cov, files: list[Path]) -> list[tuple[Path, float]]:
        """Stream file windows through a factored-once baseline: host memory
        stays bounded by the window, not the dataset."""
        from ..metric.device_scoring import PerSongScorer

        scorer = PerSongScorer(mu, cov, mesh=self.scoring_mesh)
        window = 256
        pairs: list[tuple[Path, float]] = []
        for start in range(0, len(files), window):
            embeds, kept = [], []
            for f in files[start : start + window]:
                try:
                    e = self.read_embedding_file(f)
                    if e.shape[0] < 2:
                        raise ValueError(f"{e.shape[0]} embedding frames; FAD needs 2")
                    embeds.append(e)
                    kept.append(f)
                except Exception as e:
                    log.error(f"per-song FAD failed for {f}: {e}")
            if embeds:
                pairs.extend(zip(kept, scorer.score_batch(embeds)))
        return pairs

    def _score_individual_host(self, mu, cov, files: list[Path]) -> list[tuple[Path, float]]:
        baseline_factor = FrechetBaseline(mu, cov) if self.frechet_method == "eigh" else None

        def _find_z_helper(f: Path):
            try:
                embd = self.read_embedding_file(f)
                mu_ev, cov_ev = calc_embd_statistics(embd)
                if baseline_factor is not None:
                    return baseline_factor.distance(mu_ev, cov_ev)
                return frechet_distance(mu, cov, mu_ev, cov_ev, method=self.frechet_method,
                                        device=self.ml.device)
            except Exception as e:
                import traceback

                traceback.print_exc()
                log.error(f"An error occurred calculating individual FAD using model "
                          f"{self.ml.name} on file {f}: {e}")
                return None

        with ThreadPoolExecutor(max_workers=self.audio_load_worker) as ex:
            scores = list(ex.map(_find_z_helper, files))
        return [(f, s) for f, s in zip(files, scores) if s is not None]
