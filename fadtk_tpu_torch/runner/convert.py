"""In-memory audio convert for the device pipeline: no filesystem round-trip
for convert-cache misses.

The port of ``fadtk_tpu/runner/convert.py::ClipLoader`` with its default
``host`` transport only: files whose converted wav exists are read from the
cache; misses are decoded, downmixed, Kaiser-resampled and quantized to
16-bit PCM on the decode threads by the cache writer's own
``runner/fad.py::convert_audio``, minus the wav write, so the clips are
bit-identical to the cached path's.
Misses do NOT write the convert cache: the device pipeline is the "no
filesystem caches" scoring mode. Host RAM stays O(window): files are probed a
window at a time on a thread pool.

``FADTK_TPU_CONVERT_TRANSPORT=device`` (the JAX package's accelerator
resample) is not ported and raises ``NotImplementedError``; there is no
silent fallback to ``host``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..utils import get_convert_cache_path
from .fad import convert_audio


class ClipLoader:
    """Yield model-ready clips for a file list, in file order.

    Output equals the cached path's ``FrechetAudioDistance.load_audio`` for
    every file, cache hit or miss.
    """

    def __init__(self, model, workers: int = 8):
        self.model = model
        self.workers = workers
        self.transport = os.environ.get("FADTK_TPU_CONVERT_TRANSPORT", "host")
        if self.transport == "device":
            raise NotImplementedError(
                "FADTK_TPU_CONVERT_TRANSPORT=device (resampling on the accelerator) is not "
                "ported to fadtk_tpu_torch yet (see ROADMAP.md); use the default "
                "'host' transport"
            )
        if self.transport != "host":
            raise ValueError(
                f"FADTK_TPU_CONVERT_TRANSPORT must be 'device' or 'host', got {self.transport!r}"
            )

    def _load(self, f: Path) -> np.ndarray:
        """Thread worker: the cached wav, or the in-memory convert of a miss."""
        cache = get_convert_cache_path(self.model.sr, f)
        if cache.exists():
            return self.model.load_wav(cache)
        return self.model.load_wav_array(convert_audio(f, self.model.sr))

    def iter_clips(self, files: Sequence[Path]) -> Iterator[np.ndarray]:
        """Model-ready arrays in file order. The threads decode a window of
        files at a time, ahead of the clip the caller is consuming."""
        window = max(4 * self.workers, 8)
        with ThreadPoolExecutor(max_workers=max(1, self.workers)) as ex:
            for start in range(0, len(files), window):
                yield from ex.map(self._load, files[start : start + window])
