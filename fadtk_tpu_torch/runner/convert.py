"""In-memory audio convert for the device pipeline: no filesystem round-trip
for convert-cache misses.

The port of ``fadtk_tpu/runner/convert.py::ClipLoader``. Files whose
converted wav exists are read from the cache; misses are decoded and
downmixed on the decode threads, then Kaiser-resampled and quantized to
16-bit PCM by one of two transports (``FADTK_TPU_CONVERT_TRANSPORT``):

- ``host`` (the default): on the decode threads, by the cache writer's own
  ``runner/fad.py::convert_audio`` minus the wav write, so the clips are
  bit-identical to the cached path's and only target-rate int16 goes to the
  card;
- ``device``: the misses go to the model's device in fixed-shape batches,
  grouped by (source rate, 10 s bucket) — as int16 when the whole group is
  16-bit-PCM exact (half the bytes), else float32 — and
  ``dsp/resample.py::convert_device`` resamples and quantizes them there;
  int16 comes back. Clips already at the model's rate and 16-bit exact need
  no transform and never leave the host. This moves the polyphase work off
  the host CPU; the clips then differ from the cached path's by one int16
  LSB on a small share of samples (the device GEMM sums in another order).

Misses do NOT write the convert cache: the device pipeline is the "no
filesystem caches" scoring mode, and the cache stays host-produced. Host RAM
stays O(window): files are probed a window at a time on a thread pool.

Exactness this module relies on (tests/test_torch_convert_transport.py):
resampling a clip zero-padded to a bucket equals resampling the exact-length
clip on the prefix, bit for bit (the polyphase kernel zero-pads the tail
either way), and rounding in float32 equals the cache writer's float64
``np.rint`` for all |x| < 2^15.

The host decode threads, here and in the cached path's ``runner/batch.py``,
are a ``DecodePool``: while its threads run a window, numpy's OpenBLAS runs
``max(1, cores // workers)`` threads wide, so that the threads' resample
GEMMs do not each fan out over every core on top of one another. The host
convert's int16 depends on that width (by one LSB, on a few samples in ten
thousand), so both pools decode under the one rule and the loader's clips
stay bit-identical to the cache the cached path writes.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import contextmanager, nullcontext
from functools import lru_cache
from pathlib import Path
from typing import Callable, Iterator, Sequence

import numpy as np

from ..utils import get_convert_cache_path, next_multiple, resolve_device
from . import profiling
from .fad import convert_audio

#: Pad-bucket grid for miss batches: one batch shape per (src_sr, bucket).
BUCKET_SECONDS = 10
#: Cap on samples per resample batch; rows per batch adapt to the bucket so
#: short clips batch deep while 3-minute clips go one to a batch.
MAX_BATCH_SAMPLES = 1 << 22


def rows_for_bucket(bucket: int, max_rows: int = 8) -> int:
    return max(1, min(max_rows, MAX_BATCH_SAMPLES // max(bucket, 1)))


def clip_samples(model, f: Path) -> int | None:
    """Samples of the clip ``ClipLoader`` yields for ``f``, from WAV headers
    alone: the convert cache's wav where it exists (it is read as is), else
    the source's frames resampled to the model's rate; None where no header
    tells (compressed formats)."""
    from ..audio.wavio import wav_frames
    from ..dsp.resample import resampled_length

    cache = get_convert_cache_path(model.sr, f)
    if cache.exists():
        probe = wav_frames(cache)
        return None if probe is None else probe[0]
    probe = wav_frames(f)
    return None if probe is None else resampled_length(probe[0], probe[1], model.sr)


def usable_cores() -> int:
    """The cores this process may run on (its CPU affinity)."""
    return len(os.sched_getaffinity(0))


class OpenBLASWidth:
    """The thread count of one loaded OpenBLAS library, read and set through
    its exported ``openblas_get_num_threads`` / ``openblas_set_num_threads``.

    The count is the process's: OpenBLAS's ``openblas_set_num_threads_local``
    (0.3.27, 0.3.30) sets it for every thread as well and only returns the
    previous count. So ``limit`` holds a count for a stretch of time and
    puts the old one back."""

    def __init__(self, get: Callable[[], int], set_: Callable[[int], None]):
        self.get = get
        self._set = set_

    @contextmanager
    def limit(self, width: int):
        """At most ``width`` threads inside the block, and never more than
        the count in force before it; yields the count set."""
        saved = self.get()
        width = min(width, saved)
        self._set(width)
        try:
            yield width
        finally:
            self._set(saved)


@lru_cache(maxsize=1)
def numpy_openblas() -> OpenBLASWidth | None:
    """numpy's OpenBLAS, found among the libraries mapped into the process
    (numpy's own copy first where scipy maps another), or None where numpy
    runs on another BLAS."""
    try:
        with open("/proc/self/maps") as fh:  # the path is a line's sixth field
            paths = {f[5].strip() for f in (line.split(None, 5) for line in fh)
                     if len(f) == 6 and "openblas" in f[5].rsplit("/", 1)[-1]}
    except OSError:
        return None
    for path in sorted(paths, key=lambda p: ("numpy" not in p, p)):
        lib = ctypes.CDLL(path)
        # scipy-openblas64 (numpy's wheels), scipy-openblas32, openblas64, openblas
        for prefix, suffix in (("scipy_", "64_"), ("scipy_", ""), ("", "64_"), ("", "")):
            get = getattr(lib, f"{prefix}openblas_get_num_threads{suffix}", None)
            set_ = getattr(lib, f"{prefix}openblas_set_num_threads{suffix}", None)
            if get is not None and set_ is not None:
                get.argtypes, get.restype = [], ctypes.c_int
                set_.argtypes, set_.restype = [ctypes.c_int], None
                return OpenBLASWidth(get, set_)
    return None


class DecodePool:
    """The host decode threads: ``workers`` threads that run a window of
    files at a time, while numpy's BLAS runs ``max(1, usable_cores() //
    workers)`` threads wide (never wider than it was). One thread keeps
    every core; eight on eight cores run single-threaded GEMMs side by side.
    The width holds only while a window runs, the calling thread waiting on
    it, so the caller's own BLAS keeps its width.

    Under tracing each window adds 1 to ``loader.windows`` and its width to
    ``loader.blas_threads``. Where numpy has no OpenBLAS the width is left
    as it is and counted as the cores usable, a BLAS pool's default."""

    def __init__(self, workers: int):
        self.workers = max(1, workers)
        self.width = max(1, usable_cores() // self.workers)
        self._blas = numpy_openblas()
        self._ex = ThreadPoolExecutor(max_workers=self.workers)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._ex.shutdown()
        return False

    def map(self, fn, items) -> list:
        """``fn`` over ``items`` on the threads, the results in order. Every
        item has run by the time it returns or raises."""
        limit = (self._blas.limit(self.width) if self._blas is not None
                 else nullcontext(usable_cores()))
        with limit as width:
            futures = [self._ex.submit(fn, item) for item in items]
            wait(futures)
        profiling.count("loader.windows")
        profiling.count("loader.blas_threads", width)
        return [f.result() for f in futures]


class _Miss:
    __slots__ = ("index", "mono", "int16", "n")

    def __init__(self, index: int, mono: np.ndarray, int16: np.ndarray | None):
        self.index = index
        self.mono = mono  # float32 (n,) downmixed source
        self.int16 = int16  # int16 copy when PCM-exact, else None
        self.n = mono.shape[0]


class ClipLoader:
    """Yield model-ready clips for a file list, in file order.

    Under the ``host`` transport the output equals the cached path's
    ``FrechetAudioDistance.load_audio`` for every file, cache hit or miss;
    under ``device`` it does for hits, and for misses up to the resample's
    one-LSB wiggle.
    """

    def __init__(self, model, workers: int = 8, transport: str | None = None):
        self.model = model
        self.workers = workers
        self.transport = (transport if transport is not None
                          else os.environ.get("FADTK_TPU_CONVERT_TRANSPORT", "host"))
        if self.transport not in ("device", "host"):
            raise ValueError(
                f"FADTK_TPU_CONVERT_TRANSPORT must be 'device' or 'host', got {self.transport!r}"
            )
        self.device = None
        if self.transport == "device":
            self.device = getattr(model, "device", None) or resolve_device()

    def _probe(self, f: Path):
        """Thread worker: ("hit", model-ready clip) for a cache hit or a
        host-converted miss; ("miss", float32 mono, int16 copy or None,
        source rate) for a miss under the device transport."""
        cache = get_convert_cache_path(self.model.sr, f)
        if cache.exists():
            profiling.count("loader.hits")
            with profiling.stage("loader.decode"):
                return ("hit", self.model.load_wav(cache), None, None)
        profiling.count("loader.misses")
        if self.transport == "host":
            return ("hit", self.model.load_wav_array(convert_audio(f, self.model.sr)), None, None)
        from ..audio.decode import decode_audio

        with profiling.stage("loader.decode"):
            x, src_sr = decode_audio(f)  # (channels, n) float32
            mono = np.mean(x, axis=0).astype(np.float32)  # parity: fadtk/fad.py:150
        with profiling.stage("loader.quantise"):
            scaled = mono * 32768.0
            int16 = None
            if (scaled.size and scaled.min() >= -32768.0 and scaled.max() <= 32767.0
                    and np.array_equal(scaled, np.rint(scaled))):
                int16 = scaled.astype(np.int16)
        return ("miss", mono, int16, int(src_sr))

    def _convert_misses(self, misses: list[tuple[_Miss, int]]) -> dict[int, np.ndarray]:
        """Resample and quantize the misses on the device; {index: int16 mono}."""
        import torch

        from ..dsp.resample import convert_device, resampled_length

        out: dict[int, np.ndarray] = {}
        by_shape: dict[tuple[int, int], list[_Miss]] = {}
        for m, src_sr in misses:
            if src_sr == self.model.sr and m.int16 is not None:
                # Already at rate and 16-bit exact: the transform is the
                # identity, nothing goes to the device.
                out[m.index] = m.int16
                continue
            bucket = next_multiple(m.n, BUCKET_SECONDS * src_sr)
            by_shape.setdefault((src_sr, bucket), []).append(m)

        for (src_sr, bucket), group in by_shape.items():
            rows = rows_for_bucket(bucket)
            ship_int16 = all(m.int16 is not None for m in group)
            dtype = np.int16 if ship_int16 else np.float32
            for s in range(0, len(group), rows):
                batch = group[s : s + rows]
                x = np.zeros((rows, bucket), dtype)
                for j, m in enumerate(batch):
                    x[j, : m.n] = m.int16 if ship_int16 else m.mono
                q = convert_device(torch.from_numpy(x).to(self.device), src_sr,
                                   self.model.sr).cpu().numpy()
                for j, m in enumerate(batch):
                    out[m.index] = q[j, : resampled_length(m.n, src_sr, self.model.sr)]
        return out

    def iter_clips(self, files: Sequence[Path]) -> Iterator[np.ndarray]:
        """Model-ready arrays in the order of ``files``. The device pipeline's
        speech path passes its processing order (files sorted by padding
        bucket, runner/device_pipeline.py::processing_order), and its
        checkpoint's fingerprint and cursor are over that order, so a resume
        hands this the same list's tail. The threads decode a window of
        files at a time, ahead of the clip the caller is consuming; under the
        device transport the window's misses convert in one pass. Tracing
        (runner/profiling.py) is decided afresh at each window, on the
        caller's thread."""
        window = max(4 * self.workers, 8)
        with DecodePool(self.workers) as pool:
            for start in range(0, len(files), window):
                profiling.refresh()
                with profiling.stage("loader.window"):
                    probed = pool.map(self._probe, files[start : start + window])
                    misses = [(_Miss(i, mono, int16), src_sr)
                              for i, (kind, mono, int16, src_sr) in enumerate(probed)
                              if kind == "miss"]
                    converted = {}
                    if misses:
                        with profiling.stage("loader.device_convert"):
                            converted = self._convert_misses(misses)
                for i, (kind, payload, _, _) in enumerate(probed):
                    clip = payload if kind == "hit" else self.model.load_wav_array(converted[i])
                    profiling.count("loader.files")
                    profiling.count("loader.audio_s", clip.shape[-1] / self.model.sr)
                    yield clip
