"""Module-path parity with ``fadtk.fad`` (reference fadtk/fad.py).

Reference users import the metric engine from this path; the implementation
lives in ``runner/fad.py`` and ``metric/``. This module re-exports the
reference module's public surface (fad.py:20-24,44-49,63: ``log, sox_path,
ffmpeg_path, torchaudio_backend, TORCHAUDIO_RESAMPLING, FADInfResults,
calc_embd_statistics, calc_frechet_distance, FrechetAudioDistance``), as
``fadtk_tpu.fad`` does, so ``from fadtk.fad import ...`` ports by renaming
the package only.
"""

from __future__ import annotations

import os

from .metric.frechet import calc_frechet_distance
from .metric.stats import calc_embd_statistics
from .runner.fad import FADInfResults, FrechetAudioDistance
from .utils import log

# Reference module-level knobs (fad.py:21-24). Its SoX/ffmpeg resample path
# is dead code upstream (TORCHAUDIO_RESAMPLING=True pins the torchaudio
# branch, which the Kaiser resampler in dsp/resample.py replaces); the names
# stay so that code which reads or patches them still imports.
sox_path = os.environ.get("SOX_PATH", "sox")
ffmpeg_path = os.environ.get("FFMPEG_PATH", "ffmpeg")
torchaudio_backend = os.environ.get("TORCHAUDIO_BACKEND", "soundfile")
TORCHAUDIO_RESAMPLING = True

__all__ = [
    "log",
    "sox_path",
    "ffmpeg_path",
    "torchaudio_backend",
    "TORCHAUDIO_RESAMPLING",
    "FADInfResults",
    "calc_embd_statistics",
    "calc_frechet_distance",
    "FrechetAudioDistance",
]
