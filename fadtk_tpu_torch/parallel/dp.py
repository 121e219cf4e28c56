"""Generic data-parallel device pipeline for the non-speech families.

The port of ``fadtk_tpu/parallel/dp.py``. The speech family has its own
(dp, tp) step (``parallel/tp.py``); every other family reduces to one of two
shapes, which each model describes with a spec:

- ``DpChunkSpec`` (VGGish, CLAP, CDPAM, DAC, EnCodec-48k, Whisper): a host
  ``make_chunks`` cuts a clip into fixed-shape windows and ``forward`` maps a
  batch of windows on the device to embedding frames. Chunks from many clips
  pack into batches of one size;
- ``DpWholeClipSpec`` (encodec-emb 24k): no static window; clips run at
  their exact length, grouped by shape (one batch shape per distinct length;
  the time axis is never padded, since that would change the reflect-padded
  convs).

As in the speech path, PyTorch runs one process per card: every rank of the
job walks the same clips, packs the same batch and embeds its dp slice of the
rows (the tp ranks of a dp group compute the same slice: the chunked path is
replicated over tp, as in the JAX package). Each rank folds its frames into a
masked Welford state (``metric/stats.py``) that stays on the device; the
states merge across ``mesh.dp_group`` with ``welford_merge_across`` only at a
checkpoint and at the end. Pad rows (to a multiple of dp) carry weight 0 and
drop out exactly. Frames round-trip through float16 before they are folded,
as the cached path stores them (reference fadtk/model_loader.py:47-48).

Ragged tails that cannot share the window shape (EnCodec-48k's final partial
segment runs at its exact length, reference fadtk/model_loader.py:139-152)
come from the spec's ``tail`` callback. One rank counts each clip's tail:
the one whose dp rank is the clip's index modulo dp, so n and the covariance
are counted once whatever dp is.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..metric.stats import WelfordState, welford_init, welford_merge_across, welford_update
from ..runner import profiling
from ..utils import log
from .mesh import Mesh
from .tp import _step_inputs


@dataclass
class DpChunkSpec:
    """How a fixed-window family plugs into the chunked pipeline.

    forward: (*chunk tensors on the device) -> frames (B, F, d) or (B, d),
        the same forward the cached path calls.
    make_chunks: clip -> tuple of numpy arrays whose leading dim is the
        number of chunks (e.g. (windows,) or (chunks, valid_lengths)).
    num_features: d.
    tail: optional clip -> (m, d) frames on the device computed at exact
        length outside the batches (None when every chunk is static).
    preferred_batch: chunks per device per batch.
    """

    forward: Callable[..., torch.Tensor]
    make_chunks: Callable[[np.ndarray], tuple]
    num_features: int
    tail: Optional[Callable[[np.ndarray], Optional[torch.Tensor]]] = None
    preferred_batch: int = 16


@dataclass
class DpWholeClipSpec:
    """How a family with no static window plugs into the whole-clip pipeline.

    forward: clips (B, *shape) on the device -> frames (B, F, d) or (B, d).
    prepare: host clip -> the exact-shape array the forward consumes.
    """

    forward: Callable[[torch.Tensor], torch.Tensor]
    prepare: Callable[[np.ndarray], np.ndarray]
    num_features: int
    preferred_batch: int = 16


class _RankState:
    """This rank's running (mu, M2, n) on the device, the rows of each batch
    it embeds, and the checkpoint writes (rank 0 only)."""

    def __init__(self, forward, d: int, mesh: Mesh, ckpt, initial_state):
        self.forward, self.mesh, self.ckpt = forward, mesh, ckpt
        self.state = welford_init(d, device=mesh.device)
        # A resumed pass's state is counted once: by dp rank 0.
        if initial_state is not None and mesh.dp_rank == 0:
            self.state = WelfordState(*(torch.as_tensor(x, dtype=torch.float32)
                                        .to(mesh.device) for x in initial_state))

    def fold_frames(self, frames: torch.Tensor, weights: torch.Tensor | None = None) -> None:
        if frames.ndim == 2:
            frames = frames[:, None, :]
        b, f, d = frames.shape
        flat = frames.reshape(b * f, d).to(torch.float16).float()
        mask = None if weights is None else weights.repeat_interleave(f)
        self.state = welford_update(self.state, flat, mask)

    @torch.inference_mode()
    def fold_batch(self, weights: np.ndarray, *arrays: np.ndarray) -> None:
        """Embed this rank's dp slice of a batch whose rows divide by dp."""
        n = weights.shape[0]
        pad = int(np.count_nonzero(weights == 0))
        row_samples = int(np.prod(arrays[0].shape[1:]))
        profiling.count_batch(n, pad, row_samples, (n - pad) * row_samples)
        per = n // self.mesh.dp
        rows = slice(self.mesh.dp_rank * per, (self.mesh.dp_rank + 1) * per)
        with profiling.stage("pipeline.step"):
            *xs, w = _step_inputs(self.mesh.device,
                                  *(np.ascontiguousarray(a[rows]) for a in arrays),
                                  weights[rows])
            self.fold_frames(self.forward(*xs), w)
        profiling.step_end(self.mesh.device)

    @torch.inference_mode()
    def fold_tail(self, tail, clip: np.ndarray) -> None:
        """A clip's ragged tail at its exact length, outside the batches."""
        with profiling.stage("pipeline.step"):
            profiling.step_start(self.mesh.device)
            frames = tail(clip)
            if frames is not None and frames.shape[0]:
                self.fold_frames(frames)
        profiling.step_end(self.mesh.device)

    @torch.inference_mode()
    def merged(self) -> WelfordState:
        return welford_merge_across(self.state, self.mesh.dp_group)

    def checkpoint(self, files_done: int) -> None:
        """Save the merged state: it covers the clips folded so far exactly,
        since the callers flush their pending rows first."""
        with profiling.stage("pipeline.checkpoint"):
            state = self.merged()
            if self.mesh.rank == 0:
                self.ckpt.save(tuple(x.cpu().numpy() for x in state), files_done)
            else:
                self.ckpt.mark(files_done)

    def finalize(self) -> tuple[np.ndarray, np.ndarray, int]:
        """One fetch of the merged state: (mu, cov, n) in float64."""
        with profiling.stage("pipeline.fetch"):
            mu, m2, n = self.merged()
            mu = mu.cpu().numpy().astype(np.float64)
            m2 = m2.cpu().numpy().astype(np.float64)
            n = int(n.item())
        profiling.read_steps()
        if n < 2:
            return mu, np.zeros_like(m2), n
        return mu, m2 / (n - 1), n


def _pad_rows(arrays: list[np.ndarray], taken: int, multiple: int):
    """Zero rows (weight 0) up to a multiple of ``multiple``; returns the
    arrays and the weights."""
    weights = np.ones((taken,), np.float32)
    pad = (-taken) % multiple
    if pad:
        arrays = [np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in arrays]
        weights = np.concatenate([weights, np.zeros((pad,), np.float32)])
    return arrays, weights


def dp_chunk_dataset_stats(
    spec: DpChunkSpec,
    clips_iter: Iterable[np.ndarray],
    mesh: Mesh,
    batch: int | None = None,
    ckpt=None,
    files_done: int = 0,
    initial_state=None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """(mu, cov, n_frames) over host clips for a fixed-window family.

    Chunks from consecutive clips pack into batches of ``batch`` rows
    (default ``preferred_batch`` x dp; it must divide by dp); the last batch
    is cut to the rows left, padded to a multiple of dp with weight-0 rows.

    ``ckpt``/``files_done``/``initial_state``: crash-resume (runner/resume.py).
    When a checkpoint is due the pending chunks are flushed first, so the
    saved state covers the consumed clips exactly.
    """
    dp = mesh.dp
    if batch is None:
        batch = spec.preferred_batch * dp
    if batch % dp:
        raise ValueError(f"batch {batch} must divide dp={dp}")
    rank = _RankState(spec.forward, spec.num_features, mesh, ckpt, initial_state)
    profiling.steps_begin(mesh.device)

    pending: list[tuple] = []  # per-clip tuples of chunk arrays
    n_pending = 0

    def flush(force: bool) -> None:
        nonlocal n_pending
        while n_pending >= batch or (force and n_pending):
            take, taken = [], 0
            while taken < batch and pending:
                group = pending[0]
                room = batch - taken
                if group[0].shape[0] <= room:
                    take.append(pending.pop(0))
                    taken += group[0].shape[0]
                else:
                    take.append(tuple(a[:room] for a in group))
                    pending[0] = tuple(a[room:] for a in group)
                    taken += room
            n_pending -= taken
            parts = [np.concatenate([g[i] for g in take]) for i in range(len(take[0]))]
            parts, weights = _pad_rows(parts, taken, dp)
            rank.fold_batch(weights, *parts)

    for clip in profiling.waits(clips_iter, "pipeline.wait_clips"):
        clip = np.asarray(clip)
        group = spec.make_chunks(clip)
        if group[0].shape[0]:
            pending.append(group)
            n_pending += group[0].shape[0]
        if spec.tail is not None and files_done % dp == mesh.dp_rank:
            rank.fold_tail(spec.tail, clip)
        flush(force=False)
        files_done += 1
        if ckpt is not None and ckpt.due(files_done):
            flush(force=True)
            rank.checkpoint(files_done)
    flush(force=True)
    return rank.finalize()


def dp_whole_clip_dataset_stats(
    spec: DpWholeClipSpec,
    clips_iter: Iterable[np.ndarray],
    mesh: Mesh,
    batch: int | None = None,
    ckpt=None,
    files_done: int = 0,
    initial_state=None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """(mu, cov, n_frames) over host clips for a whole-clip family.

    Clips group by exact prepared shape; a group dispatches when it holds
    ``batch`` clips (default ``preferred_batch`` x dp, rounded down to a
    multiple of dp), the rest at the end, padded to a multiple of dp with
    weight-0 zero clips (the forward is per-clip independent). Host RAM stays
    bounded: past 4 x ``batch`` buffered clips the largest group flushes
    early. At a checkpoint every buffered group dispatches first, so the
    saved state covers the consumed clips exactly.
    """
    dp = mesh.dp
    if batch is None:
        batch = spec.preferred_batch * dp
    batch = max(dp, (batch // dp) * dp)
    rank = _RankState(spec.forward, spec.num_features, mesh, ckpt, initial_state)
    profiling.steps_begin(mesh.device)

    groups: dict[tuple, list[np.ndarray]] = defaultdict(list)
    n_buffered = 0
    max_buffered = 4 * batch
    warned_shapes = False

    def dispatch(rows: list[np.ndarray]) -> None:
        (stacked,), weights = _pad_rows([np.stack(rows)], len(rows), dp)
        rank.fold_batch(weights, stacked)

    for clip in profiling.waits(clips_iter, "pipeline.wait_clips"):
        c = spec.prepare(np.asarray(clip))
        bucket = groups[c.shape]
        bucket.append(c)
        n_buffered += 1
        if len(bucket) >= batch:
            dispatch(bucket[:batch])
            del bucket[:batch]
            n_buffered -= batch
        if n_buffered > max_buffered:
            if not warned_shapes and len(groups) > max_buffered // 2:
                warned_shapes = True
                log.info(f"whole-clip dp: {len(groups)} distinct clip shapes buffered; "
                         "flushing early to bound host RAM")
            shape = max(groups, key=lambda k: len(groups[k]))
            flushed = groups.pop(shape)
            dispatch(flushed)
            n_buffered -= len(flushed)
        files_done += 1
        if ckpt is not None and ckpt.due(files_done):
            for shape in list(groups):
                rows = groups.pop(shape)
                if rows:
                    dispatch(rows)
            n_buffered = 0
            rank.checkpoint(files_done)
    for bucket in groups.values():
        if bucket:
            dispatch(bucket)
    return rank.finalize()
