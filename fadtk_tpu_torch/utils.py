"""Shared utilities: cache path scheme, device selection and small helpers.

The on-disk cache layout is the inter-stage API of the reference and is the
same as ``fadtk_tpu``'s, so either package reads the other's caches
(reference fadtk/utils.py:60-68, fadtk/fad.py:143-147,268-274):

    {dataset}/convert/{sr}/{name}.wav          resampled mono 16-bit PCM audio
    {dataset}/embeddings/{model}/{stem}.npy    float16 (n_frames, n_features)
    {dataset}/stats/{model}/mu.npy|cov.npy     dataset Gaussian statistics
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Union

PathLike = Union[str, Path]

log = logging.getLogger("fadtk_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s fadtk_tpu_torch] %(message)s"))
    log.addHandler(_h)
    log.setLevel(os.environ.get("FADTK_LOGLEVEL", "INFO"))


def resolve_device():
    """The torch device the models and device scoring run on.

    ``cuda`` unless ``FADTK_TPU_TORCH_DEVICE`` names another (the counterpart
    of ``JAX_PLATFORMS``). Asking for ``cuda`` on a machine without a usable
    card raises: the package never moves to the CPU by itself.
    """
    import torch

    name = os.environ.get("FADTK_TPU_TORCH_DEVICE", "").strip() or "cuda"
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False; "
            "set FADTK_TPU_TORCH_DEVICE=cpu to run on the CPU"
        )
    return device


def get_cache_embedding_path(model: str, audio_path: PathLike) -> Path:
    """Path of the cached embedding .npy for an audio file.

    Layout parity: reference fadtk/utils.py:60-68.
    """
    audio_path = Path(audio_path)
    return audio_path.parent / "embeddings" / model / audio_path.with_suffix(".npy").name


def get_convert_cache_path(sr: int, audio_path: PathLike) -> Path:
    """Path of the cached resampled wav for an audio file.

    Layout parity: reference fadtk/fad.py:143-144.
    """
    audio_path = Path(audio_path)
    return (audio_path.parent / "convert" / str(sr) / audio_path.name).with_suffix(".wav")


def get_stats_cache_dir(dataset_dir: PathLike, model: str) -> Path:
    """Directory of the cached (mu, cov) statistics for a dataset directory.

    Layout parity: reference fadtk/fad.py:268.
    """
    return Path(dataset_dir) / "stats" / model


def dataset_files(path: PathLike) -> list[Path]:
    """Audio files of a dataset directory: non-recursive ``*.*`` glob, like the
    reference (fadtk/fad.py:215, fadtk/fad_batch.py:32)."""
    return sorted(p for p in Path(path).glob("*.*") if p.is_file())


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (length-bucket padding helper)."""
    return ((x + m - 1) // m) * m
