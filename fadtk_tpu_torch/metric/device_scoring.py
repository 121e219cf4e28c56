"""On-device bulk scoring: the FAD-inf subsample sweep and per-song FAD.

The port of ``fadtk_tpu/metric/device_scoring.py``, in plain torch on an
explicit device. These are the throughput modes of the two expensive scoring
loops; the host float64 paths of ``runner/fad.py`` stay the parity defaults.
The device versions give up the last digits (float32 accumulation, ~1e-3
relative) to keep each loop on the card:

- FAD-inf: each of the sweep's steps draws a with-replacement subsample on
  the device, takes its masked Welford moments (one product over the drawn
  frames) and the exact trace of the Fréchet distance; only the steps'
  scalars come back to the host.
- per-song: the per-file Gaussians and distances run in batches, against a
  baseline square root factored once.

Traces come from exact eigenvalues. A covariance of n frames has rank at
most n - 1, and a song or a subsample with fewer frames than embedding dims
is the normal case (Whisper: 2 frames; CLAP ~1 a second; FAD-inf's min_n =
500 against d = 512-1280). Per song the trace is the spectrum of the Gram of
the sqrt-projected frames, (L, L) or (D, D), whichever side is smaller, with
zero eigenvalues clipped. The FAD-inf step takes ``eigvalsh`` of the (D, D)
product and keeps its top min(n - 1, D) eigenvalues: the others are float32
rounding noise around 0, whose square roots would add up to ~6e-4 of the
score at n = 500, d = 768.

One difference from the JAX package: its FAD-inf step takes a 30-iteration
Newton-Schulz trace where n >= 4d. That iteration is reliable only where
s1 C2 s1 is well conditioned, and embedding covariances need not be: on
w2v2-base's embeddings the product's eigenvalues span about eight decades,
and in float32 the 30 iterations converge at some steps of the sweep and
diverge at others (``chip_smoke.py`` prints both traces at three steps;
``tests/test_torch_scoring.py::test_trace_step_ill_conditioned_baseline``
holds a case where they miss). So every step here takes the exact trace.

All products run in full float32 (``_baseline`` and ``_batch_moments`` turn
TF32 off on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .stats import welford_finalize, welford_init, welford_merge_across, welford_update


def _sqrt_psd_eigh(m: torch.Tensor) -> torch.Tensor:
    """Exact PSD square root by eigendecomposition (safe for singular input,
    unlike Newton-Schulz; computed once per baseline)."""
    ev, u = torch.linalg.eigh((m + m.T) * 0.5)
    return (u * ev.clamp(min=0.0).sqrt()) @ u.T


def _fad_trace_step(mu1, s1, tr1, n_i: int, d: int, mu2, cov2) -> torch.Tensor:
    """FAD of (mu2, cov2), the moments of n_i frames, against the factored
    baseline. Tr sqrtm is the sum of the square roots of the top
    min(n_i - 1, d) eigenvalues of the symmetrised s1 C2 s1 (its rank bound;
    the rest of its spectrum is rounding noise), clipped at 0."""
    m = s1 @ cov2 @ s1
    ev = torch.linalg.eigvalsh((m + m.T) * 0.5)[max(d - (n_i - 1), 0):]
    diff = mu1 - mu2
    return diff @ diff + tr1 + torch.trace(cov2) - 2.0 * ev.clamp(min=0.0).sqrt().sum()


def _dp_quota_split(ns: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Exact integer split of each subsample size proportional to the shards'
    valid counts: floor-diff over the prefix sums. Each row sums to exactly
    n_i and each rank's quota is at most its valid count (so a (Nl,) sample
    buffer always fits). Returns (steps, dp) int32."""
    cum = np.concatenate([[0], np.cumsum(np.asarray(valid, np.int64))])
    edges = np.asarray(ns, np.int64)[:, None] * cum[None, :] // max(cum[-1], 1)
    return np.diff(edges, axis=1).astype(np.int32)


def _rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank``'s draws in a dp-sharded sweep."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])


def _baseline(mu_base, cov_base, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu1, sqrtm(C1), Tr C1) in float32 on ``device``."""
    mu1 = torch.as_tensor(np.asarray(mu_base), dtype=torch.float32, device=device)
    cov1 = torch.as_tensor(np.asarray(cov_base), dtype=torch.float32, device=device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return mu1, _sqrt_psd_eigh(cov1), torch.trace(cov1)


def fad_inf_device(
    mu_base: np.ndarray,
    cov_base: np.ndarray,
    embeds: np.ndarray,
    steps: int = 25,
    min_n: int = 500,
    seed: int = 0,
    mesh=None,
) -> tuple[float, float, float, list[tuple[int, float]]]:
    """Device FAD-inf sweep. Returns (score, slope, r2, points): the same ns
    grid and 1/n linear extrapolation as the host ``score_inf``.

    Each step draws ``max_n`` indices from a ``torch.Generator`` on the
    device seeded with ``seed``, gathers the frames (float16 frames, the
    cache's dtype, upcast after the gather: f16 -> f32 is exact) and keeps
    the first n_i under a mask. The draws differ from the JAX package's
    ``jax.random`` ones, so the result is statistically equivalent to its
    sweep, not equal; a seed reproduces it exactly on one device type.

    ``mesh`` (``parallel.mesh.Mesh``, dp > 1; every rank of the job calls
    this with the same arguments): rank r keeps only its N/dp rows on its
    device and draws its quota of each step (``_dp_quota_split``) from a
    generator seeded from (seed, r); one ``welford_merge_across`` per step
    gives the global moments and the trace math runs replicated. Every rank
    returns the same result, statistically equivalent to the single-device
    sweep and reproducible per (seed, dp).
    """
    max_n = len(embeds)
    ns = [int(n) for n in np.linspace(min_n, max_n, steps)]
    embeds = np.asarray(embeds)
    if embeds.dtype != np.float16:
        embeds = embeds.astype(np.float32)
    d = embeds.shape[1]
    sharded = mesh is not None and mesh.dp > 1
    device = mesh.device if mesh is not None else resolve_device()
    mu1, s1, tr1 = _baseline(mu_base, cov_base, device)

    if sharded:
        nl = -(-max_n // mesh.dp)  # rows per rank (the last shard short)
        valid = np.clip(max_n - nl * np.arange(mesh.dp), 0, nl)
        quotas = _dp_quota_split(np.asarray(ns), valid)[:, mesh.dp_rank]
        start = nl * mesh.dp_rank
        rows = torch.from_numpy(embeds[start : start + nl]).to(device)
        n_rows = max(int(valid[mesh.dp_rank]), 1)
        gen = torch.Generator(device=device).manual_seed(_rank_seed(seed, mesh.dp_rank))
        group, cap = mesh.dp_group, nl
    else:
        quotas = ns
        rows = torch.from_numpy(embeds).to(device)
        n_rows = max_n
        gen = torch.Generator(device=device).manual_seed(seed)
        group, cap = None, max_n
    positions = torch.arange(cap, device=device)

    fads = []
    for n_i, quota in zip(ns, quotas):
        idx = torch.randint(0, n_rows, (cap,), generator=gen, device=device)
        sample = rows[idx].float()
        mask = (positions < int(quota)).float()
        st = welford_merge_across(welford_update(welford_init(d, device=device), sample, mask),
                                  group)
        mu2, cov2 = welford_finalize(st)
        fads.append(_fad_trace_step(mu1, s1, tr1, n_i, d, mu2, cov2))
    fads = torch.stack(fads).double().cpu().numpy()

    xs = 1.0 / np.asarray(ns, np.float64)
    slope, intercept = np.polyfit(xs, fads, 1)
    r2 = 1 - np.sum((fads - (slope * xs + intercept)) ** 2) / np.sum((fads - np.mean(fads)) ** 2)
    points = [(n, float(f)) for n, f in zip(ns, fads)]
    return float(intercept), float(slope), float(r2), points


def _per_song_batch(mu1, s1, tr1, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """frames: (B, L, D) padded per-song frames (any float dtype; accumulated
    in float32); masks: (B, L). Returns (B,) float32 FADs.

    Tr sqrt comes from the exact nonzero spectrum of W = centred_frames @ s1
    / sqrt(n - 1): spec+(W Wᵀ) == spec+(Wᵀ W) == spec+(s1 C2 s1). The Gram
    side follows the pad bucket: (L, L) when L <= D, else (D, D), so
    frame-dense songs (EnCodec at 75 Hz: minutes of audio are 10k+ frames)
    never build an (L, L) batch. Masked rows are exact zero rows of W and
    clip away."""
    frames = frames.float()
    masks = masks.float()
    n = masks.sum(dim=1)
    mu2 = (frames * masks[..., None]).sum(dim=1) / n.clamp(min=1.0)[:, None]
    xc = (frames - mu2[:, None]) * masks[..., None]
    dof = (n - 1.0).clamp(min=1.0)
    w = (xc @ s1) / dof.sqrt()[:, None, None]
    wt = w.transpose(1, 2)
    gram = w @ wt if w.shape[1] <= w.shape[2] else wt @ w
    ev = torch.linalg.eigvalsh((gram + gram.transpose(1, 2)) * 0.5)
    tr_sqrt = ev.clamp(min=0.0).sqrt().sum(dim=-1)
    tr_cov2 = (xc * xc).sum(dim=(1, 2)) / dof
    diff = mu1 - mu2
    return (diff * diff).sum(dim=-1) + tr1 + tr_cov2 - 2.0 * tr_sqrt


class PerSongScorer:
    """Streaming per-song FAD against one baseline.

    Factors sqrtm(C_base) once (exact eigh square root) and scores any number
    of song batches against it; the runner streams file windows through
    ``score_batch``, so host memory stays bounded by the window.

    Pad lengths round up to multiples of ``len_bucket`` frames (the masked
    moments make padding exact). Frames go to the device as float16, their
    cache dtype, and are upcast there.

    ``mesh`` (dp > 1; every rank of the job calls ``score_batch`` with the
    same songs): each device step takes ``batch_size`` x dp songs, rank r
    scores its ``batch_size`` of them and the scores are gathered, so every
    rank returns all scores, equal to a single device's at ``batch_size`` x
    dp (per-song math is independent).
    """

    def __init__(self, mu_base: np.ndarray, cov_base: np.ndarray, batch_size: int = 16,
                 len_bucket: int = 128, mesh=None):
        self.mesh = mesh if mesh is not None and mesh.dp > 1 else None
        self.device = mesh.device if mesh is not None else resolve_device()
        self.mu1, self.s1, self.tr1 = _baseline(mu_base, cov_base, self.device)
        self.batch_size = batch_size
        self.len_bucket = len_bucket

    def score_batch(self, song_embeddings: list[np.ndarray]) -> np.ndarray:
        import torch.distributed as dist

        d = song_embeddings[0].shape[-1]
        dp = self.mesh.dp if self.mesh is not None else 1
        bs = self.batch_size * dp
        scores = np.empty(len(song_embeddings), np.float64)
        for start in range(0, len(song_embeddings), bs):
            group = song_embeddings[start : start + bs]
            longest = max(e.shape[0] for e in group)
            pad_len = -(-longest // self.len_bucket) * self.len_bucket
            frames = np.zeros((bs, pad_len, d), np.float16)
            masks = np.zeros((bs, pad_len), np.float32)
            for j, e in enumerate(group):
                frames[j, : e.shape[0]] = np.asarray(e, np.float16)
                masks[j, : e.shape[0]] = 1.0
            if self.mesh is not None:
                mine = slice(self.mesh.dp_rank * self.batch_size,
                             (self.mesh.dp_rank + 1) * self.batch_size)
                frames, masks = frames[mine], masks[mine]
            out = _per_song_batch(self.mu1, self.s1, self.tr1,
                                  torch.from_numpy(frames).to(self.device),
                                  torch.from_numpy(masks).to(self.device))
            if self.mesh is not None:
                parts = [torch.empty_like(out) for _ in range(dp)]
                dist.all_gather(parts, out, group=self.mesh.dp_group)
                out = torch.cat(parts)
            scores[start : start + len(group)] = out[: len(group)].double().cpu().numpy()
        return scores


def per_song_fad_device(
    mu_base: np.ndarray,
    cov_base: np.ndarray,
    song_embeddings: list[np.ndarray],
    batch_size: int = 16,
) -> np.ndarray:
    """FAD of each song's own Gaussian against the baseline, batched on the
    device (the device mode of ``score_individual``)."""
    return PerSongScorer(mu_base, cov_base, batch_size=batch_size).score_batch(song_embeddings)
