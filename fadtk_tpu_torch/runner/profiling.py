"""Lightweight per-stage wall-clock profiling.

The pipeline accumulates host wall-clock per stage (load_audio / embed) and
reports it at the end of a run. Device work is asynchronous; the embed stage
ends in a host copy of the embeddings, which waits for the device, so its
total includes the device time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

from ..utils import log

_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextmanager
def stage(name: str):
    start = time.perf_counter()
    try:
        yield
    finally:
        _totals[name] += time.perf_counter() - start
        _counts[name] += 1


def report(reset: bool = True) -> dict[str, float]:
    """Log and return the per-stage totals in seconds (and clear them)."""
    snapshot = dict(_totals)
    if snapshot:
        parts = ", ".join(
            f"{k}={v:.2f}s/{_counts[k]}x" for k, v in sorted(snapshot.items())
        )
        log.info(f"[profile] {parts}")
    if reset:
        _totals.clear()
        _counts.clear()
    return snapshot
