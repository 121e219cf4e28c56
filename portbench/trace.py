"""Spans, counters and the reading of the profiler's trace.

Host spans (name, start, end on ``time.perf_counter``) and counters live in
memory on the ``Record`` of a run; the metric readers of
``portbench/metrics`` read them after the window. Under ``--trace 1`` the
window runs inside ``torch.profiler`` and ``summarize`` reduces the trace to
what the readers need: device busy time (the union of every kernel, copy
and set interval inside the window, so kernels that overlap count once),
device time by kernel name, device time under each ``portbench.*`` range
(the kernels inside the range's GPU-side span), and the device's idle gaps,
each named by the innermost ``portbench.*`` range, else the outermost op,
that the host was inside at the gap's middle.

``kernel_table`` is the device-time-by-kernel reduction of chip_smoke.py's
``profile_forward`` / ``forward_breakdown`` (frozen copy, commit d8bf949),
applied to the whole window instead of one forward.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

RANGE_PREFIX = "portbench."


@dataclass
class Record:
    """What one run recorded: host spans and counters (filled under
    ``--trace 1`` only), the window, the calls and the trace's summary."""

    spans: list = field(default_factory=list)  # (name, t0, t1) perf_counter seconds
    counters: dict = field(default_factory=lambda: defaultdict(float))
    window_s: float = 0.0
    chips: int = 1
    calls: list = field(default_factory=list)  # per completed call: dict
    trace: dict | None = None  # summarize()'s output on this rank
    peak_window_bytes: int = 0
    precision: str = "float32"

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1))

    def span_total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)


class timed_span:
    """Context manager recording a host span on ``record``."""

    def __init__(self, record: Record, name: str):
        self.record, self.name = record, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.record.span(self.name, self.t0, time.perf_counter())
        return False


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kernel_table(device_events) -> dict[str, float]:
    """Device seconds by kernel name (chip_smoke.py's reduction)."""
    kernels: dict[str, float] = defaultdict(float)
    for e in device_events:
        kernels[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    return dict(kernels)


def summarize(prof, window_range: str = RANGE_PREFIX + "window") -> dict:
    """Reduce a finished ``torch.profiler.profile`` to the numbers the
    readers use (seconds)."""
    import torch

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    cpu_events = [e for e in events if e.device_type != cuda]
    windows = [e for e in cpu_events if e.name == window_range]
    if not windows:
        return {}
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    # Device events are kernels, copies and sets, and the GPU side of each
    # profiler range (``gpu_user_annotation``: ours, and the library's such
    # as ``nccl:all_reduce``), which spans the kernels launched inside the
    # range and carries its name; those are told apart by name.
    cpu_names = {e.name for e in cpu_events}
    annotations: dict[str, list] = defaultdict(list)
    device = []
    for e in events:
        if e.device_type != cuda or e.time_range.start >= w1 or e.time_range.end <= w0:
            continue
        if e.name in cpu_names or e.name.startswith(RANGE_PREFIX):
            annotations[e.name].append((e.time_range.start, e.time_range.end))
        else:
            device.append(e)
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    kernels = kernel_table(device)
    # Device time under each of our ranges: the kernels whose middle lies in
    # one of the range's GPU-side spans (one stream: they do not interleave).
    ranges: dict[str, float] = defaultdict(float)
    range_ops: dict[str, dict] = defaultdict(lambda: defaultdict(float))
    for full, spans in annotations.items():
        if not full.startswith(RANGE_PREFIX) or full == window_range:
            continue
        name = full[len(RANGE_PREFIX):]
        spans = _union(spans)
        starts = [x[0] for x in spans]
        for e in device:
            mid = (e.time_range.start + e.time_range.end) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                d = (e.time_range.end - e.time_range.start) / 1e6
                ranges[name] += d
                range_ops[name][e.name] += d

    # Idle gaps inside the window, named by what the host was inside.
    gaps = []
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    # Ours nest (call > step > attention; call > loader_wait) and never
    # overlap a range of their own name, so one sorted list a name serves a
    # binary search; ops are searched among those whose parent is none or
    # one of ours (the outermost op), by start.
    ours: dict[str, list] = defaultdict(list)
    outer = []
    for ev in cpu_events:
        if ev.name == window_range:
            continue
        if ev.name.startswith(RANGE_PREFIX):
            ours[ev.name].append((ev.time_range.start, ev.time_range.end))
        elif ev.cpu_parent is None or ev.cpu_parent.name.startswith(RANGE_PREFIX):
            outer.append((ev.time_range.start, ev.time_range.end, ev.name))
    ours_sorted = {k: sorted(v) for k, v in ours.items()}
    ours_starts = {k: [x[0] for x in v] for k, v in ours_sorted.items()}
    outer.sort()
    outer_starts = [o[0] for o in outer]

    def covering(spans, starts, t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and spans[i][1] >= t, i

    idle: dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        best = None  # innermost of ours: the latest start among those covering mid
        for name, spans in ours_sorted.items():
            hit, i = covering(spans, ours_starts[name], mid)
            if hit and (best is None or spans[i][0] > best[0]):
                best = (spans[i][0], name)
        if best is not None:
            label = best[1]
        else:
            hit, i = covering(outer, outer_starts, mid)
            label = outer[i][2] if hit else "host outside any op"
        idle[label] += (e - s) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "kernel_s": sum(kernels.values()),
        "kernels": kernels,
        "ranges": dict(ranges),
        "range_ops": {k: dict(v) for k, v in range_ops.items()},
        "idle": dict(idle),
    }


def top(table: dict[str, float], n: int = 10, width: int = 120) -> list[list]:
    return [[k[:width], v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
