"""Frechet distance between two Gaussians.

    d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2))

Three evaluators for the hard term ``Tr sqrtm(C1 C2)``, as in
``fadtk_tpu.metric.frechet``:

- ``eigh`` (default, host float64): the symmetric reformulation
  ``Tr sqrtm(C1 C2) = Tr sqrtm(S1 C2 S1)`` with ``S1 = sqrtm(C1)`` via eigh.
  Bit-identical to the JAX package's host path.
- ``reference`` (host float64): bit-faithful replication of the reference's
  dual computation — scipy ``sqrtm`` cross-check plus general ``eig`` value,
  the eps jitter fallback, the imaginary-component checks and the
  trace-discrepancy warning (reference fadtk/fad.py:51-120).
- ``newton_schulz`` (device float32): a Newton-Schulz iteration in torch —
  matrix products only — on the chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import log, resolve_device

# --------------------------------------------------------------------------- #
# Host float64 paths
# --------------------------------------------------------------------------- #


def _trace_sqrtm_product_eigh(cov1: np.ndarray, cov2: np.ndarray) -> float:
    """Tr sqrtm(C1 C2) via the symmetric form, float64, eigh only.

    C1 = U diag(a) U^T  =>  S1 = U diag(sqrt(max(a,0))) U^T
    M  = S1 C2 S1 is symmetric PSD and similar to sqrt-able C1 C2, so
    Tr sqrtm(C1 C2) = sum sqrt(eigvalsh(M)) with eigenvalues clipped at 0.
    """
    from scipy import linalg

    a, u = linalg.eigh(cov1.astype(np.float64))
    s1 = (u * np.sqrt(np.clip(a, 0.0, None))) @ u.T
    m = s1 @ cov2.astype(np.float64) @ s1
    m = (m + m.T) * 0.5
    ev = linalg.eigvalsh(m)
    return float(np.sum(np.sqrt(np.clip(ev, 0.0, None))))


def _trace_sqrtm_product_reference(
    cov1: np.ndarray, cov2: np.ndarray, eps: float = 1e-6
) -> float:
    """The reference's computation of Tr sqrtm(C1 C2), warnings and all.

    Behavior parity: reference fadtk/fad.py:86-117 — the returned trace comes
    from the general (non-symmetric) eigendecomposition; scipy's sqrtm runs as a
    cross-check and a >1e-3 trace disagreement only logs a warning.
    """
    from numpy.lib.scimath import sqrt as scisqrt
    from scipy import linalg

    prod = cov1.dot(cov2)
    covmean_sqrtm = linalg.sqrtm(prod)

    d, v = linalg.eig(prod)
    covmean = (v * scisqrt(d)) @ linalg.inv(v)

    if not np.isfinite(covmean).all():
        log.info(
            "fid calculation produces singular product; "
            f"adding {eps} to diagonal of cov estimates"
        )
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset).dot(cov2 + offset))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    tr_covmean = np.trace(covmean)
    tr_sqrtm = np.trace(covmean_sqrtm)
    if np.iscomplexobj(tr_sqrtm) and np.abs(tr_sqrtm.imag) < 1e-3:
        tr_sqrtm = tr_sqrtm.real
    if not np.iscomplexobj(tr_sqrtm):
        delt = np.abs(tr_covmean - tr_sqrtm)
        if delt > 1e-3:
            log.warning(f"Detected high error in sqrtm calculation: {delt}")

    return float(tr_covmean)


# --------------------------------------------------------------------------- #
# Device path: Newton-Schulz sqrtm trace (matrix products only)
# --------------------------------------------------------------------------- #


def _ns_sqrt_sym(m: torch.Tensor, iters: int) -> torch.Tensor:
    """Newton-Schulz square root of a symmetric PSD matrix.

    Scaled so that ||M/c - I|| < 1 guarantees convergence; returns sqrt(M).
    The loop body is two DxD products.
    """
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    norm = torch.sqrt(torch.sum(m * m)).clamp(min=1e-30)
    y = m / norm
    z = eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    return y * torch.sqrt(norm)


def trace_sqrtm_product_ns(
    cov1: torch.Tensor, cov2: torch.Tensor, iters: int = 30
) -> torch.Tensor:
    """Tr sqrtm(C1 C2) via two Newton-Schulz square roots.

    Symmetric form: S1 = sqrt(C1); Tr sqrtm(C1 C2) = Tr sqrt(S1 C2 S1).
    """
    s1 = _ns_sqrt_sym((cov1 + cov1.T) * 0.5, iters)
    m = s1 @ cov2.to(cov1.dtype) @ s1
    m = (m + m.T) * 0.5
    return torch.trace(_ns_sqrt_sym(m, iters))


def frechet_distance_device(
    mu1: torch.Tensor, cov1: torch.Tensor, mu2: torch.Tensor, cov2: torch.Tensor,
    iters: int = 30,
) -> torch.Tensor:
    """Full Frechet distance on the tensors' device (float32 Newton-Schulz)."""
    diff = mu1 - mu2
    tr = trace_sqrtm_product_ns(cov1, cov2, iters=iters)
    return diff @ diff + torch.trace(cov1) + torch.trace(cov2) - 2.0 * tr


# --------------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------------- #


def frechet_distance(
    mu1, cov1, mu2, cov2, *, method: str = "eigh", eps: float = 1e-6, device=None
):
    """Frechet distance between N(mu1, C1) and N(mu2, C2).

    ``method``: 'eigh' (host f64, default), 'reference' (host f64, bit-faithful
    replication of fadtk), or 'newton_schulz' (f32 on ``device``, default
    ``utils.resolve_device()``). Input validation parity: reference
    fadtk/fad.py:72-81.
    """
    mu1 = np.atleast_1d(np.asarray(mu1))
    mu2 = np.atleast_1d(np.asarray(mu2))
    cov1 = np.atleast_2d(np.asarray(cov1))
    cov2 = np.atleast_2d(np.asarray(cov2))

    assert mu1.shape == mu2.shape, (
        f"Training and test mean vectors have different lengths ({mu1.shape} vs {mu2.shape})"
    )
    assert cov1.shape == cov2.shape, (
        f"Training and test covariances have different dimensions ({cov1.shape} vs {cov2.shape})"
    )

    # The reference subtracts means at their stored precision (eval means can be
    # float16, fadtk/fad.py:48,83); numpy's promotion reproduces that here.
    diff = mu1.astype(np.float64) - mu2.astype(np.float64)

    if method == "reference":
        tr = _trace_sqrtm_product_reference(
            cov1.astype(np.float64), cov2.astype(np.float64), eps=eps
        )
    elif method == "eigh":
        tr = _trace_sqrtm_product_eigh(cov1, cov2)
    elif method == "newton_schulz":
        dev = device if device is not None else resolve_device()
        tr = float(
            trace_sqrtm_product_ns(
                torch.as_tensor(cov1, dtype=torch.float32, device=dev),
                torch.as_tensor(cov2, dtype=torch.float32, device=dev),
            )
        )
    else:
        raise ValueError(f"Unknown frechet method: {method}")

    return float(
        diff.dot(diff)
        + np.trace(cov1.astype(np.float64))
        + np.trace(cov2.astype(np.float64))
        - 2.0 * tr
    )


class FrechetBaseline:
    """Precomputed baseline factorization for bulk scoring.

    ``Tr sqrtm(C1 C2) = Tr sqrtm(S1 C2 S1)`` needs ``S1 = sqrtm(C1)`` only
    once per baseline, halving the host eigendecompositions versus calling
    :func:`frechet_distance` per pair.
    """

    def __init__(self, mu1, cov1):
        from scipy import linalg

        self.mu1 = np.atleast_1d(np.asarray(mu1)).astype(np.float64)
        cov1 = np.atleast_2d(np.asarray(cov1)).astype(np.float64)
        self.tr1 = float(np.trace(cov1))
        a, u = linalg.eigh(cov1)
        self.s1 = (u * np.sqrt(np.clip(a, 0.0, None))) @ u.T

    def distance(self, mu2, cov2) -> float:
        from scipy import linalg

        mu2 = np.atleast_1d(np.asarray(mu2)).astype(np.float64)
        cov2 = np.atleast_2d(np.asarray(cov2)).astype(np.float64)
        m = self.s1 @ cov2 @ self.s1
        ev = linalg.eigvalsh((m + m.T) * 0.5)
        tr_sqrt = float(np.sum(np.sqrt(np.clip(ev, 0.0, None))))
        diff = self.mu1 - mu2
        return float(diff.dot(diff) + self.tr1 + np.trace(cov2) - 2.0 * tr_sqrt)
