"""Gaussian statistics of embedding frames (host, numpy).

The host-exact half of ``fadtk_tpu.metric.stats``, kept line for line so that
it is bit-identical to it (tests/test_torch_host.py). It replicates the
reference's numerics: per-file partials ``(mean, cov*(n-1), n)`` merged
sequentially with the Chan et al. parallel-update formula (reference
fadtk/utils.py:13-46); in-memory statistics are plain ``np.mean`` + ``np.cov``
(reference fadtk/fad.py:42-48).

State convention: ``(mu, M2, n)`` with ``cov = M2 / (n - 1)``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..utils import PathLike


def calc_embd_statistics(embd: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and unbiased covariance of a (n_frames, n_features) array.

    Parity: reference fadtk/fad.py:42-48 — including the float16 mean dtype when
    the input is float16 and the float64 covariance from np.cov.
    """
    assert embd.shape[0] >= 2, (
        f"FAD requires at least two embedding frames, you have {embd.shape}. "
        "(This probably means that your audio is too short)"
    )
    return np.mean(embd, axis=0), np.cov(embd, rowvar=False)


def file_partial_stats(file: PathLike) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-file partial statistics ``(mean, cov*(n-1), n)``.

    Parity: reference fadtk/utils.py:13-16.
    """
    embd = np.load(file)
    n = embd.shape[0]
    return np.mean(embd, axis=0), np.cov(embd, rowvar=False) * (n - 1), n


def merge_partial_stats(
    mu: np.ndarray, s: np.ndarray, n: int, mu_b: np.ndarray, s_b: np.ndarray, n_b: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Chan et al. pairwise merge of two ``(mu, M2, n)`` partials.

    Parity: the update inside the loop of reference fadtk/utils.py:36-40.
    """
    delta = mu_b - mu
    mu = mu + n_b / (n + n_b) * delta
    s = s + s_b + np.outer(delta, delta) * n * n_b / (n + n_b)
    return mu, s, n + n_b


def calculate_embd_statistics_online(
    files: Sequence[PathLike],
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming dataset statistics over per-file embedding .npy files.

    Parity: reference fadtk/utils.py:19-46 (same accumulation order: files are
    folded sequentially into a float64 accumulator).
    """
    assert len(files) > 0, "No files provided"

    embd_dim = np.load(files[0], mmap_mode="r").shape[-1]
    mu = np.zeros(embd_dim)
    s = np.zeros((embd_dim, embd_dim))
    n = 0

    for f in files:
        mu_b, s_b, n_b = file_partial_stats(f)
        mu, s, n = merge_partial_stats(mu, s, n, mu_b, s_b, n_b)

    if n < 2:
        return mu, np.zeros_like(s)
    return mu, s / (n - 1)


def statistics_from_frame_iter(
    frames: Iterable[np.ndarray], dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming statistics over an iterator of (n_i, dim) frame arrays, without
    touching the filesystem. Same merge semantics as the online path."""
    mu = np.zeros(dim)
    s = np.zeros((dim, dim))
    n = 0
    for x in frames:
        if x.shape[0] == 0:
            continue
        n_b = x.shape[0]
        mu_b = np.mean(x, axis=0)
        s_b = np.cov(x, rowvar=False) * (n_b - 1) if n_b > 1 else np.zeros((dim, dim))
        mu, s, n = merge_partial_stats(mu, s, n, mu_b, s_b, n_b)
    if n < 2:
        return mu, np.zeros_like(s)
    return mu, s / (n - 1)
