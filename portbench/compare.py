"""The comparison that decides ``correct`` for a dataset-statistics cell.

Each call of the window returned a Gaussian (mu, cov, n) of its dataset; the
reference's Gaussian of the same files is worked out from its per-file
moments. Three numbers a call, each taken as the worst over the calls:

- ``n_mismatch``: |n - n_ref|, frames counted; limit 0, exact;
- ``mu_err``: max_j |mu_j - mu_ref_j| / sqrt(cov_ref_jj), the mean's error in
  the reference's standard deviations of that feature;
- ``cov_err``: max_jk |cov_jk - cov_ref_jk| / sqrt(cov_ref_jj cov_ref_kk), the
  covariance's error on the scale of a correlation.

The limits of each cell sit in ``portbench/limits/<cell>.json``, with the
readings they were set from (PERF.md, "How correct is decided").
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NUMBERS = ("n_mismatch", "mu_err", "cov_err")


def compare_call(mu, cov, n, mu_ref, cov_ref, n_ref) -> dict[str, float]:
    sd = np.sqrt(np.diag(cov_ref))
    return {
        "n_mismatch": float(abs(int(n) - int(n_ref))),
        "mu_err": float(np.max(np.abs(mu - mu_ref) / sd)),
        "cov_err": float(np.max(np.abs(cov - cov_ref) / np.outer(sd, sd))),
    }


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    return {k: max((r[k] for r in readings), default=float("nan")) for k in NUMBERS}


def load_limits(cell: str, directory: Path = LIMITS_DIR) -> dict[str, float]:
    spec = json.loads((directory / f"{cell}.json").read_text())
    return {k: float(spec[k]["limit"]) for k in NUMBERS}


def within(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
