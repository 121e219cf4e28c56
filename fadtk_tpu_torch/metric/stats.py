"""Gaussian statistics of embedding frames.

The port of ``fadtk_tpu.metric.stats``, in its two halves:

1. **Host-exact path** (numpy), kept line for line so that it is
   bit-identical to the JAX package's (tests/test_torch_host.py). It
   replicates the reference's numerics: per-file partials ``(mean, cov*(n-1),
   n)`` merged sequentially with the Chan et al. parallel-update formula
   (reference fadtk/utils.py:13-46); in-memory statistics are plain
   ``np.mean`` + ``np.cov`` (reference fadtk/fad.py:42-48).

2. **Device path** (torch, float32, on the tensors' device): the streaming
   masked Welford/Chan accumulator of the device pipeline. A batch's second
   moment is one mean-centred ``xcᵀ·xc`` product, and partials merge across
   the data-parallel ranks with three ``all_reduce``s using the generalized
   Chan identity

       mu  = (sum_i n_i mu_i) / n
       M2  = sum_i [ M2_i + n_i (mu_i - mu)(mu_i - mu)^T ]

   which is algebraically identical to folding the pairwise merge over all
   ranks at once. These products must run in full float32: on the card
   ``torch.backends.cuda.matmul.allow_tf32`` is False by default, and
   ``_batch_moments`` sets it False again (TF32 would keep ~3 digits of the
   covariance).

State convention (both paths): ``(mu, M2, n)`` with ``cov = M2 / (n - 1)``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

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


# --------------------------------------------------------------------------- #
# Device path: streaming masked Welford/Chan accumulator
# --------------------------------------------------------------------------- #


def merge_partial_stats_device(state, mu_b, m2_or_cov_b, n_b, b_is_cov: bool = False):
    """Device-resident Chan merge chain (the formula of ``merge_partial_stats``,
    float32).

    Keeping the running (mu, M2, n) on the device keeps the accumulation loop
    asynchronous: the host never fetches per-batch partials, so decode
    threads and device steps overlap (one fetch at the end syncs). ``state``
    None starts the chain on ``mu_b``'s device. ``b_is_cov=True`` takes a
    finalized covariance for the incoming partial (the sharded speech step's
    output) and rescales it to M2 by ``max(n_b - 1, 0)``. Zero-count partials
    merge exactly (the ``max(n, 1)`` guard).
    """
    mu_b = mu_b.float()
    m2_b = m2_or_cov_b.float()
    n_b = torch.as_tensor(n_b, dtype=torch.float32, device=mu_b.device)
    if b_is_cov:
        m2_b = m2_b * (n_b - 1.0).clamp(min=0.0)
    a = welford_init(mu_b.shape[0], device=mu_b.device) if state is None else WelfordState(*state)
    return tuple(welford_merge(a, WelfordState(mu_b, m2_b, n_b)))


class WelfordState(NamedTuple):
    """Streaming second-moment state. ``cov = m2 / (n - 1)``."""

    mu: torch.Tensor  # (D,)   running mean
    m2: torch.Tensor  # (D, D) running centred second moment (sum of outer products)
    n: torch.Tensor  # ()     running frame count (float, like the JAX state)


def welford_init(dim: int, dtype=torch.float32, device=None) -> WelfordState:
    return WelfordState(
        mu=torch.zeros((dim,), dtype=dtype, device=device),
        m2=torch.zeros((dim, dim), dtype=dtype, device=device),
        n=torch.zeros((), dtype=dtype, device=device),
    )


def _batch_moments(x: torch.Tensor, mask: torch.Tensor | None, dtype) -> WelfordState:
    """One-shot moments of a (B, D) batch with an optional (B,) validity mask.

    The second moment is computed mean-centred, ``(X-mu)^T (X-mu)``: stable,
    and one matrix product, in full float32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    x = x.to(dtype)
    if mask is None:
        n_b = torch.tensor(float(x.shape[0]), dtype=dtype, device=x.device)
        mu_b = x.mean(dim=0)
        xc = x - mu_b
    else:
        mask = mask.to(dtype)
        n_b = mask.sum()
        # Guard against empty batches: normalise by max(n_b, 1).
        mu_b = (x * mask[:, None]).sum(dim=0) / n_b.clamp(min=1.0)
        xc = (x - mu_b) * mask[:, None]
    return WelfordState(mu=mu_b, m2=xc.T @ xc, n=n_b)


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan pairwise merge. Zero-count partials are handled exactly (the
    delta term vanishes and the mean is untouched)."""
    n = a.n + b.n
    denom = n.clamp(min=1.0)
    delta = b.mu - a.mu
    mu = a.mu + delta * (b.n / denom)
    m2 = a.m2 + b.m2 + torch.outer(delta, delta) * (a.n * b.n / denom)
    return WelfordState(mu=mu, m2=m2, n=n)


def welford_update(
    state: WelfordState, x: torch.Tensor, mask: torch.Tensor | None = None
) -> WelfordState:
    """Fold a (B, D) batch of frames into the running state."""
    return welford_merge(state, _batch_moments(x, mask, state.mu.dtype))


def welford_finalize(state: WelfordState) -> tuple[torch.Tensor, torch.Tensor]:
    """(mu, cov) with the unbiased n-1 normalisation (reference
    fadtk/utils.py:45), the denominator guarded at 1."""
    return state.mu, state.m2 / (state.n - 1.0).clamp(min=1.0)


def welford_merge_across(state: WelfordState, group=None) -> WelfordState:
    """Merge the partials of every rank of the process ``group`` (the dp
    group) with three ``all_reduce``s; the identity when ``group`` is None
    or has one rank. Exact: the generalized Chan identity of the module
    docstring."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return state
    n = state.n.clone()
    dist.all_reduce(n, group=group)
    denom = n.clamp(min=1.0)
    mu = state.mu * state.n
    dist.all_reduce(mu, group=group)
    mu = mu / denom
    delta = state.mu - mu
    m2 = state.m2 + torch.outer(delta, delta) * state.n
    dist.all_reduce(m2, group=group)
    return WelfordState(mu=mu, m2=m2, n=n)
