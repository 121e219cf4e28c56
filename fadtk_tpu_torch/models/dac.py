"""DAC embedding model (`dac-44kHz`).

Port of ``fadtk_tpu/models/dac.py`` (reference fadtk/model_loader.py:189-251):

- audiotools preprocessing: loudness-normalize to -16 dB LUFS (:222),
  peak-limit to |x| <= 1 (:223), zero-pad to a multiple of the 5 s window
  (:228-229), collect 5 s windows with 50% overlap (:230);
- per window: the DAC 44 kHz encoder -> (430, 1024) latents, concatenated
  (:236-244).

The loudness meter runs on the host (``dsp/loudness.py``); windows of several
files batch together, ``WINDOW_BATCH`` to a forward.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..dsp.loudness import normalize_loudness
from ..utils import log, resolve_device
from .base import EmbeddingModel
from .dac_impl import DAC_44K, DACEncoder, dac_encode, init_dac_params

_SR = 44100
_WIN = int((5.0 * _SR) // 4 * 4)  # 220500; reference :214-216
_HOP = _WIN // 2


class DACModel(EmbeddingModel):
    WINDOW_BATCH = 8  # 5 s windows per forward

    def __init__(self):
        super().__init__("dac-44kHz", 1024, _SR)
        self.cfg = DAC_44K

    def weights_name(self) -> str:
        return "dac_44khz"

    def load_model(self) -> None:
        from ..weights.store import (
            MissingWeightsError,
            load_params,
            params_from_jax,
            params_path,
            random_weights_enabled,
        )

        self.device = resolve_device()
        path = params_path(self.weights_name())
        if path.exists():
            stored = load_params(path)
            stored.pop("__config__", None)
            module = DACEncoder(self.cfg)
            module.load_state_dict(params_from_jax(stored, conv_layout="OIH"))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_dac_params(DACEncoder(self.cfg), torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError(
                self.weights_name(), "descript-audio-codec weights_44khz.pth"
            )
        self.module = module.to(self.device)

    def _make_windows(self, audio: np.ndarray) -> np.ndarray:
        """audiotools sanitization (reference :222-223) + 5 s / 50%-hop windows,
        (n_windows, 1, 220500) float32."""
        x = np.asarray(audio, np.float64).reshape(-1)
        x = normalize_loudness(x, self.sr, -16.0).astype(np.float64)
        peak = np.abs(x).max()
        if peak > 1.0:
            x = x / peak

        n_win_units = max(1, math.ceil(x.shape[0] / _WIN))
        padded = np.zeros(n_win_units * _WIN, np.float32)
        padded[: x.shape[0]] = x
        num_windows = (padded.shape[0] - _WIN) // _HOP + 1
        return np.stack(
            [padded[i * _HOP : i * _HOP + _WIN] for i in range(num_windows)]
        )[:, None, :]

    @torch.inference_mode()
    def _forward(self, windows: np.ndarray) -> np.ndarray:
        """(n, 1, 220500) host windows -> (n, 430, 1024) host float32."""
        x = torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(self.device)
        return dac_encode(self.module, x).cpu().numpy()

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        return self._forward(self._make_windows(audio)).reshape(-1, self.num_features)

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file window batching (5 s windows are independent)."""
        self.ensure_loaded()
        per_file = [self._make_windows(np.asarray(c)) for c in clips]
        outs = self._batch_chunked(per_file, self._forward, batch_size=self.WINDOW_BATCH)
        return [o.reshape(-1, self.num_features).astype(np.float16) for o in outs]
