"""The port's tracing: named host spans and counters, off by default.

``stage(name)`` is a span around a piece of host work and ``count(name,
value)`` adds to a counter. With tracing off each costs one check of a module
flag: no clock read, no profiler range, no CUDA event, no lock.

Tracing is on

- while ``FADTK_TPU_TRACE=<dir>`` is set: ``traced`` wraps each dataset pass
  of the device pipeline and each batch run of the cached path in a
  ``torch.profiler`` session of its own, writes that session's chrome trace
  (program ranges and the device timeline on one clock) to
  ``<dir>/trace-rank<r>-<n>.json`` and logs the record's totals in a
  ``[profile]`` line;
- while a ``torch.profiler`` started by the caller is recording.

``refresh`` decides, on the thread that drives the pass, at the start of each
pass and at each loader window. The decode threads read the flag it sets:
torch reports no profiler on a pool thread, and a ``record_function`` opened
there never reaches the profiler's events. A record starts afresh whenever
tracing turns on, so its totals cover the traced stretch and nothing before
it. (Torch gives a profiler session no identity, so two sessions with no
untraced pass between them share one record; each ``FADTK_TPU_TRACE``
session has its own.)

When on, a span adds its host seconds (``time.perf_counter``) and one call
to thread-safe totals under its name. On the thread that turned tracing on
it also opens a ``record_function`` range named ``fadtk.<name>``, which puts
it on the profiler's timeline beside the device's, and under Nsight Systems
with ``torch.autograd.profiler.emit_nvtx`` makes it an NVTX range.

The device's side of a pass: ``step_start`` and ``step_end`` record CUDA
events on the current stream just before a step's first copy to the device
and just after its statistics are folded in; ``read_steps``, called once the
pass has fetched its state (so with no synchronisation of its own), adds
their intervals to the counters ``pipeline.step_device_s`` and, from one
step's end to the next step's start, ``pipeline.device_gap_s``: the time the
device waited for the host to enqueue. The last end event is kept across
passes, so a gap over a pass boundary counts too.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
from torch.autograd.profiler import record_function

from ..utils import log

ENV = "FADTK_TPU_TRACE"
PREFIX = "fadtk."


class _Record:
    """What tracing recorded since it last turned on."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = defaultdict(float)
        self.steps: list = []  # (start, end) CUDA events not yet read
        self.start = None  # the current step's start event
        self.last_end = None  # the newest end event read


_on = False
_owner = None  # ident of the thread that turned tracing on
_lock = threading.Lock()
_rec = _Record()
_session = None  # the profiler FADTK_TPU_TRACE started, while it records
_NULL = nullcontext()


def _begin() -> None:
    """Turn tracing on with a fresh record, owned by the calling thread."""
    global _on, _owner, _rec
    _rec = _Record()
    _owner = threading.get_ident()
    _on = True


def _wanted() -> bool:
    return torch.autograd._profiler_enabled()


def refresh() -> bool:
    """Turn tracing on or off as a profiler on this thread is recording or
    not; a fresh record when it turns on. Called by the thread that drives
    a pass; returns whether tracing is on."""
    global _on
    want = _wanted()
    if want and not _on:
        _begin()
    elif not want and _on:
        _on = False
    return _on


class _Span:
    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if threading.get_ident() == _owner:
            self.range = record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = _rec
        with _lock:
            rec.seconds[self.name] += dt
            rec.calls[self.name] += 1
        return False


def stage(name: str):
    """A span around the ``with`` block: host seconds and a call under
    ``name``, and a ``fadtk.<name>`` profiler range on the owning thread."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to the counter ``name``."""
    if not _on:
        return
    rec = _rec
    with _lock:
        rec.counters[name] += value


def count_batch(rows: int, pad_rows: int, row_samples: int, valid_samples: int) -> None:
    """The padding counters of one step: ``rows`` handed to it, of which
    ``pad_rows`` are padding, each of ``row_samples`` samples, and
    ``valid_samples`` of all those marked valid."""
    count("pipeline.steps")
    count("pipeline.rows", rows)
    count("pipeline.pad_rows", pad_rows)
    count("pipeline.bucket_samples", rows * row_samples)
    count("pipeline.valid_samples", valid_samples)


def waits(iterable, name: str):
    """The items of ``iterable``, each taken inside the span ``name``."""
    it = iter(iterable)
    while True:
        with stage(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _timing_event(device: torch.device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def steps_begin(device: torch.device) -> None:
    """At the start of a pass: when the record has no end event yet, one
    now, so that the wait before the record's first step counts as a gap."""
    if _on and device.type == "cuda" and _rec.last_end is None and not _rec.steps:
        _rec.last_end = _timing_event(device)


def step_start(device: torch.device) -> None:
    """Just before a step's first copy to ``device``."""
    if _on and device.type == "cuda":
        _rec.start = _timing_event(device)


def step_end(device: torch.device) -> None:
    """Just after a step's statistics are folded into the pass's state."""
    rec = _rec
    if _on and device.type == "cuda" and rec.start is not None:
        rec.steps.append((rec.start, _timing_event(device)))
        rec.start = None


def read_steps() -> None:
    """Add the recorded steps to ``pipeline.step_device_s`` and
    ``pipeline.device_gap_s``. Call after the pass has fetched its state
    from the device, so every event has completed."""
    rec = _rec
    if not _on or not rec.steps:
        return
    busy = gap = 0.0
    for start, end in rec.steps:
        busy += start.elapsed_time(end) / 1e3
        if rec.last_end is not None:
            gap += rec.last_end.elapsed_time(start) / 1e3
        rec.last_end = end
    rec.steps = []
    count("pipeline.step_device_s", busy)
    count("pipeline.device_gap_s", gap)


def snapshot() -> dict:
    """The record: ``{"seconds": {span: host s}, "calls": {span: n},
    "counters": {name: value}}``. Spans on the decode threads add thread
    seconds, which may exceed the wall time they overlap."""
    rec = _rec
    with _lock:
        return {"seconds": dict(rec.seconds), "calls": dict(rec.calls),
                "counters": dict(rec.counters)}


def report(what: str) -> None:
    """Log the record's totals in one ``[profile]`` line when tracing is on."""
    if not _on:
        return
    snap = snapshot()
    parts = [f"{k}={v:.3f}s/{snap['calls'][k]}x" for k, v in sorted(snap["seconds"].items())]
    parts += [f"{k}={v:g}" for k, v in sorted(snap["counters"].items())]
    log.info(f"[profile] {what}: {', '.join(parts)}")


def _trace_path(out: Path) -> Path:
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    while (out / f"trace-rank{rank}-{n}.json").exists():
        n += 1
    return out / f"trace-rank{rank}-{n}.json"


@contextmanager
def traced(what: str):
    """Around a dataset pass or a batch run. Under ``FADTK_TPU_TRACE`` (and
    not inside another such session) it runs in a profiler session of its
    own with a fresh record, whose chrome trace is written at the end;
    otherwise tracing follows the caller's profiler (``refresh``). Either
    way, when tracing is on, the record's totals are logged at the end."""
    global _session, _on
    out = os.environ.get(ENV)
    if not out or _session is not None:
        refresh()
        yield
        report(what)
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _session = prof
        _begin()
        try:
            yield
        finally:
            _session = None
    path = _trace_path(Path(out))
    prof.export_chrome_trace(str(path))
    report(what)
    log.info(f"[profile] trace written to {path}")
    _on = False
