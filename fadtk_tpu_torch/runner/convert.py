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
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

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
        """Model-ready arrays in file order. The threads decode a window of
        files at a time, ahead of the clip the caller is consuming; under the
        device transport the window's misses convert in one pass. Tracing
        (runner/profiling.py) is decided afresh at each window, on the
        caller's thread."""
        window = max(4 * self.workers, 8)
        with ThreadPoolExecutor(max_workers=max(1, self.workers)) as ex:
            for start in range(0, len(files), window):
                profiling.refresh()
                with profiling.stage("loader.window"):
                    probed = list(ex.map(self._probe, files[start : start + window]))
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
