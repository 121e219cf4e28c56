"""The dataset Gaussian of the reference, in float64.

Frames are stored as float16 before they are accumulated (the embedding
cache's format, fadtk/model_loader.py:47-48), so the reference rounds them
the same way. A dataset that lists a file k times counts its frames k times.
The mean and the unbiased covariance follow from per-file moments with the
exact pooled identity

    n = sum_i c_i n_i,  mu = sum_i c_i n_i mu_i / n,
    M2 = sum_i c_i (M2_i + n_i mu_i mu_i^T) - n mu mu^T,  cov = M2 / (n - 1),

with M2_i the centred second moment of file i and c_i its count.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FileMoments:
    n: np.ndarray  # (files,) int64 frame counts
    mu: torch.Tensor  # (files, D) float64
    m2: torch.Tensor  # (files, D, D) float64, centred


def frame_moments(frames: list[torch.Tensor]) -> FileMoments:
    """Moments of each file's (frames, D) float32 states after the float16
    round trip."""
    mus, m2s, ns = [], [], []
    for x in frames:
        x = x.to(torch.float16).to(torch.float64)
        mu = x.mean(dim=0)
        xc = x - mu
        mus.append(mu)
        m2s.append(xc.T @ xc)
        ns.append(x.shape[0])
    return FileMoments(np.asarray(ns, np.int64), torch.stack(mus), torch.stack(m2s))


def dataset_gaussian(m: FileMoments, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(mu, cov, n) of a dataset in which file i appears ``counts[i]`` times."""
    c = torch.as_tensor(counts, dtype=torch.float64, device=m.mu.device)
    ni = torch.as_tensor(m.n, dtype=torch.float64, device=m.mu.device)
    n = int((counts * m.n).sum())
    wts = c * ni
    mu = (wts[:, None] * m.mu).sum(0) / n
    m2 = torch.tensordot(c, m.m2, dims=1) + (m.mu.T * wts) @ m.mu - n * torch.outer(mu, mu)
    return mu.cpu().numpy(), (m2 / (n - 1)).cpu().numpy(), n
