"""CUDA-event timing for a later per-kernel metric.

Frozen copy of chip_smoke.py's ``cuda_ms`` (commit d8bf949).
"""

from __future__ import annotations

import statistics


def cuda_ms(torch, fn, runs: int = 25, groups: int = 5) -> float:
    """Time per call (ms), after two warm-up calls: the median over
    ``groups`` of the CUDA-event time of ``runs // groups`` back-to-back
    calls, divided by their number. Back to back, the host enqueues the next
    call while the card runs this one, so a short kernel's time excludes its
    wrapper's Python checks."""
    for _ in range(2):
        fn()
    groups = min(groups, runs)
    per = runs // groups
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)
