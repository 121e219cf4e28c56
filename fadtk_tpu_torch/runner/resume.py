"""Crash-resume checkpoints for the streaming device pipeline.

The port of ``fadtk_tpu/runner/resume.py``, kept line for line: the same
fingerprint, npz layout, atomic temp+rename and ``FADTK_TPU_CKPT*`` knobs, so
a checkpoint written by either package resumes in the other
(tests/test_torch_device_pipeline.py).

The cached-embedding path resumes per file for free (skip-if-cached, the
reference's semantics, fadtk/fad.py:188-195); ``--device-pipeline`` skips
those caches, so its running Gaussian partials live only in memory. This
module periodically writes the device-resident ``(mu, M2, n)`` triple plus a
processed-file cursor to disk (atomic temp+rename, as the embedding cache
writes in runner/fad.py), and on start resumes from it, skipping processed
files.

Checkpoints are **file-aligned by construction**: on the speech path
(runner/device_pipeline.dataset_stats_device) a save happens only after a
whole batch of clips (one clip = one batch row), so a resumed run with the
same ``batch`` re-batches identically and the final stats are
**bit-identical** to an uninterrupted run (the f32 state round-trips through
the npz losslessly).

The checkpoint is keyed by a fingerprint of (model cache name, feature dim,
ordered file names); anything stale, corrupt, or mismatched is ignored and
the pass starts fresh. Success deletes the file. Cadence: every
``FADTK_TPU_CKPT_FILES`` files (default 1024) or ``FADTK_TPU_CKPT_SECONDS``
seconds (default 60), whichever comes first; each save costs one host fetch
of the (d, d) triple (~4 MB at d=1024). ``FADTK_TPU_CKPT=0`` disables
checkpointing entirely.
"""

from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from ..utils import PathLike, log

CKPT_VERSION = 1

HostState = tuple[np.ndarray, np.ndarray, np.ndarray]  # (mu, M2, n) float32


def checkpointing_enabled() -> bool:
    return os.environ.get("FADTK_TPU_CKPT", "1") != "0"


def pipeline_ckpt_path(dataset_dir: PathLike, model) -> Path:
    """Checkpoint location: under the dataset's stats dir (the same directory
    the cached path would put mu.npy/cov.npy in), keyed by the model's cache
    name so f32 and bf16 passes never collide."""
    return Path(dataset_dir) / "stats" / model.cache_name / "pipeline_ckpt.npz"


class StatsCheckpoint:
    """Atomic (mu, M2, n, files_done) checkpoint for one dataset pass."""

    def __init__(
        self,
        path: PathLike,
        fingerprint: str,
        every_files: int | None = None,
        every_seconds: float | None = None,
    ):
        self.path = Path(path)
        self.fingerprint = fingerprint
        self.every_files = (
            every_files
            if every_files is not None
            else int(os.environ.get("FADTK_TPU_CKPT_FILES", "1024"))
        )
        self.every_seconds = (
            every_seconds
            if every_seconds is not None
            else float(os.environ.get("FADTK_TPU_CKPT_SECONDS", "60"))
        )
        self._last_files = 0
        self._last_time = time.monotonic()

    # ---------------------------------------------------------------- #

    @staticmethod
    def fingerprint_of(model, files: Sequence[PathLike]) -> str:
        """Identity of a dataset pass: model cache name (captures bf16 mode),
        feature dim, and the ordered file names. File ORDER matters — the
        cursor indexes into this exact sequence."""
        h = hashlib.sha256()
        h.update(model.cache_name.encode())
        h.update(str(int(model.num_features)).encode())
        h.update(str(len(files)).encode())
        for f in files:
            h.update(Path(f).name.encode())
            h.update(b"\0")
        return h.hexdigest()

    # ---------------------------------------------------------------- #

    def load(self) -> tuple[HostState | None, int]:
        """Resume point: (host (mu, M2, n), files_done), or (None, 0) when the
        checkpoint is absent, corrupt, from another dataset/model, or from an
        older format version."""
        try:
            with np.load(self.path) as z:
                if int(z["version"]) != CKPT_VERSION:
                    return None, 0
                if str(z["fingerprint"]) != self.fingerprint:
                    return None, 0
                state = (
                    np.asarray(z["mu"], np.float32),
                    np.asarray(z["m2"], np.float32),
                    np.asarray(z["n"], np.float32),
                )
                return state, int(z["files_done"])
        except FileNotFoundError:
            return None, 0
        except Exception as e:  # corrupt/partial file: start fresh, keep going
            log.warning(f"ignoring unreadable pipeline checkpoint {self.path}: {e}")
            return None, 0

    def due(self, files_done: int) -> bool:
        return (
            files_done - self._last_files >= self.every_files
            or time.monotonic() - self._last_time >= self.every_seconds
        )

    def save(self, state_host: HostState, files_done: int) -> None:
        """Atomic write (temp + os.replace): a kill at any instant leaves
        either the previous checkpoint or this one, never a torn file."""
        mu, m2, n = state_host
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.parent / f".{self.path.name}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                version=np.int64(CKPT_VERSION),
                fingerprint=self.fingerprint,
                mu=np.asarray(mu, np.float32),
                m2=np.asarray(m2, np.float32),
                n=np.asarray(n, np.float32),
                files_done=np.int64(files_done),
            )
        os.replace(tmp, self.path)
        self._last_files = files_done
        self._last_time = time.monotonic()

    def finalize(self) -> None:
        """The pass completed: the checkpoint has served its purpose."""
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass
        # Undo save()'s mkdir of the stats dir when nothing else lives there,
        # so a dataset that only ever saw the device pipeline does not
        # present an empty stats/<model>/ dir to the cached-path tooling.
        # Only in the DEFAULT {dir}/stats/{model}/pipeline_ckpt.npz layout
        # (pipeline_ckpt_path): a user-supplied --checkpoint path in a
        # directory they created must never have it deleted out from under
        # them, even when empty.
        if self.path.name == "pipeline_ckpt.npz" and self.path.parent.parent.name == "stats":
            try:
                self.path.parent.rmdir()
            except OSError:
                pass  # non-empty (real cached stats) or already gone


def open_checkpoint(
    checkpoint: PathLike | None, model, files: Sequence[PathLike]
) -> tuple["StatsCheckpoint | None", HostState | None, int]:
    """Shared entry for the pipeline paths: build the StatsCheckpoint (or None
    when disabled/pathless) and load any resume point. Logs the resume."""
    if checkpoint is None or not checkpointing_enabled():
        return None, None, 0
    ckpt = StatsCheckpoint(checkpoint, StatsCheckpoint.fingerprint_of(model, files))
    state, files_done = ckpt.load()
    if files_done:
        log.info(
            f"device pipeline: resuming from checkpoint at file {files_done}/"
            f"{len(files)} ({ckpt.path})"
        )
    return ckpt, state, files_done
