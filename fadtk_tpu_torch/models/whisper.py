"""Whisper embedding models.

Port of ``fadtk_tpu/models/whisper.py`` (reference fadtk/model_loader.py:636-672):
`whisper-{tiny,base,small,medium,large}` at 16 kHz. Each clip is one fixed
30 s window (the HF feature extractor pads or truncates); the frontend
(``dsp/mel.py::whisper_log_mel``, float32, one launch of the fused log-mel
kernel per batch on the card) feeds a full seq2seq forward with two forced
decoder-start tokens, whose decoder last_hidden_state is the embedding:
exactly 2 frames per clip.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..dsp.mel import WHISPER_SAMPLES, whisper_log_mel
from ..utils import log, resolve_device
from .base import EmbeddingModel
from .whisper_impl import Whisper, config_for_size, init_whisper_params, whisper_forward

_DIMS = {"tiny": 384, "base": 512, "small": 768, "medium": 1024, "large": 1280}


class WhisperModel(EmbeddingModel):
    # 30 s windows per device forward (cross-file).
    BATCH = 16

    def __init__(self, size: str):
        if size not in _DIMS:
            raise ValueError(f"unknown whisper size {size!r}")
        super().__init__(f"whisper-{size}", _DIMS[size], 16000)
        self.size = size
        self.cfg = config_for_size(size)
        self.hf_source = f"openai/whisper-{size}"

    def weights_name(self) -> str:
        return self.hf_source.replace("/", "__")

    def load_model(self) -> None:
        from ..weights.store import (
            MissingWeightsError,
            decode_config_meta,
            load_params,
            params_from_jax,
            params_path,
            random_weights_enabled,
        )

        self.device = resolve_device()
        path = params_path(self.weights_name())
        if path.exists():
            stored = load_params(path)
            meta = stored.pop("__config__", None)
            if meta is not None:
                self.cfg = replace(self.cfg, **decode_config_meta(meta))
            module = Whisper(self.cfg)
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_whisper_params(Whisper(self.cfg), torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError(self.weights_name(), f"HF id {self.hf_source}")
        self.module = module.to(self.device)

    @staticmethod
    def _make_chunk(audio: np.ndarray) -> np.ndarray:
        """One fixed 30 s window per clip (HF extractor pads/truncates)."""
        clip = np.zeros((WHISPER_SAMPLES,), np.float32)
        n = min(audio.shape[0], WHISPER_SAMPLES)
        clip[:n] = audio[:n]
        return clip

    @torch.inference_mode()
    def _forward_clips(self, clips: np.ndarray) -> np.ndarray:
        """(B, 480000) host windows -> (B, 2, d) host float32."""
        audio = torch.from_numpy(np.ascontiguousarray(clips, np.float32)).to(self.device)
        return whisper_forward(self.module, whisper_log_mel(audio)).cpu().numpy()

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        return self._forward_clips(self._make_chunk(np.asarray(audio))[None])[0]

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file batching: each clip is one 30 s window, ``BATCH`` windows
        per forward (the last one is not padded). Returns (2, d) float16 per
        clip (the cache format)."""
        self.ensure_loaded()
        windows = np.stack([self._make_chunk(np.asarray(c)) for c in clips])
        out: list[np.ndarray] = []
        for start in range(0, len(clips), self.BATCH):
            out.extend(self._forward_clips(windows[start : start + self.BATCH]).astype(np.float16))
        return out

    def dp_spec(self):
        """Chunked device pipeline: one 30 s window per clip; the frontend
        (K3 on the card) runs inside the batch's forward."""
        from ..parallel.dp import DpChunkSpec

        self.ensure_loaded()
        return DpChunkSpec(
            forward=lambda clips: whisper_forward(self.module, whisper_log_mel(clips)),
            make_chunks=lambda clip: (self._make_chunk(np.asarray(clip))[None],),
            num_features=self.num_features,
            preferred_batch=self.BATCH,
        )
