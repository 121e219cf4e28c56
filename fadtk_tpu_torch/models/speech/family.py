"""EmbeddingModel wrapper for the speech-transformer family.

Behaviour shared across the w2v2, HuBERT, WavLM and MERT variants (reference
fadtk/model_loader.py:525-633, 254-288), as in
``fadtk_tpu.models.speech.family``:

- 6-minute truncation with a warning (fadtk/model_loader.py:549-551);
- run the encoder once and tap one hidden-state layer (:556-557);
- audio padded to 10 s length buckets at the model's own rate (160,000
  samples / 499 frames at 16 kHz, 240,000 / 749 for MERT at 24 kHz) and
  batched ``MAX_BATCH`` clips at a time; the encoder's exact masking makes
  the valid frames equal an unpadded run, so batching is score-neutral.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

from ...utils import log, next_multiple, resolve_device
from ..base import EmbeddingModel
from .config import SpeechEncoderConfig
from .encoder import SpeechEncoder, init_speech_encoder

BUCKET_SECONDS = 10


class SpeechEmbeddingModel(EmbeddingModel):
    """Base for the w2v2/hubert/wavlm/mert registry entries."""

    # Clips per device batch; the last partial group of a bucket pads rows.
    MAX_BATCH = 16

    def __init__(
        self,
        name: str,
        num_features: int,
        sr: int,
        cfg: SpeechEncoderConfig,
        layer: int,
        hf_source: str,
        limit_minutes: int = 6,
    ):
        super().__init__(name, num_features, sr)
        self.cfg = cfg
        self.layer = layer
        self.hf_source = hf_source
        self.limit = limit_minutes * 60 * sr

    # -- weights ------------------------------------------------------- #

    def weights_name(self) -> str:
        """Checkpoint file key: per-layer variants share one backbone file."""
        return self.hf_source.replace("/", "__")

    def load_model(self) -> None:
        from ...weights.store import (
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
                # Conversion-time architecture/processor facts win over our
                # defaults (fadtk_tpu/weights/convert_cli.py).
                self.cfg = replace(self.cfg, **decode_config_meta(meta))
            module = SpeechEncoder(self.cfg)
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_speech_encoder(
                SpeechEncoder(self.cfg), torch.Generator().manual_seed(0)
            )
        else:
            raise MissingWeightsError(self.weights_name(), f"HF id {self.hf_source}")
        self.module = module.to(self.device)

    # -- embedding ----------------------------------------------------- #

    @torch.inference_mode()
    def _forward(self, audio: np.ndarray, num_valid: np.ndarray, taps):
        """(B, T) host audio -> host (n_taps, B, T_frames, H) states and
        (B,) valid frame counts."""
        states, mask = self.module(
            torch.from_numpy(audio).to(self.device),
            torch.from_numpy(num_valid).to(self.device),
            taps,
        )
        n_frames = mask.float().sum(dim=1).to(torch.int64).cpu().numpy()
        return states, n_frames

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        if audio.shape[0] > self.limit:
            log.warning(
                f"Audio is too long ({audio.shape[0] / self.sr / 60:.2f} minutes > "
                f"{self.limit / self.sr / 60:.2f} minutes). Truncating."
            )
            audio = audio[: self.limit]
        return self.embed_batch([audio])[0]

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Batched multi-clip embedding: truncate, bucket by padded length,
        run fixed-size device batches, slice per-clip valid frames. Returns
        float16 arrays (the cache format)."""
        self.ensure_loaded()
        results: list[np.ndarray | None] = [None] * len(clips)

        groups: dict[int, list] = defaultdict(list)
        for i, clip in enumerate(clips):
            clip = np.asarray(clip)[: self.limit]
            bucket = next_multiple(max(clip.shape[0], 1), BUCKET_SECONDS * self.sr)
            groups[bucket].append((i, clip))

        for bucket, items in groups.items():
            for g in range(0, len(items), self.MAX_BATCH):
                chunk = items[g : g + self.MAX_BATCH]
                b = len(chunk)
                # Pad the batch to MAX_BATCH when the bucket spans several
                # batches, so every batch of the bucket has one shape.
                b_pad = self.MAX_BATCH if len(items) > self.MAX_BATCH else b
                audio = np.zeros((b_pad, bucket), np.float32)
                num_valid = np.zeros((b_pad,), np.int32)
                for j, (_, clip) in enumerate(chunk):
                    audio[j, : clip.shape[0]] = clip
                    num_valid[j] = max(clip.shape[0], 1)
                num_valid[b:] = 1  # keep masked norms well-defined on padding rows
                states, n_frames = self._forward(audio, num_valid, (self.layer,))
                states = states[0].to(torch.float16).cpu().numpy()
                for j, (idx, _) in enumerate(chunk):
                    results[idx] = states[j, : n_frames[j]]
        return results  # type: ignore[return-value]

    def embed_all_layers(self, audio: np.ndarray) -> np.ndarray:
        """(num_layers + 1, n_frames, H) float32 — one forward, every layer tap."""
        self.ensure_loaded()
        audio = np.asarray(audio)[: self.limit]
        n = audio.shape[0]
        bucket = next_multiple(max(n, 1), BUCKET_SECONDS * self.sr)
        padded = np.zeros((1, bucket), np.float32)
        padded[0, :n] = audio
        states, n_frames = self._forward(padded, np.asarray([max(n, 1)], np.int32), None)
        return states[:, 0, : n_frames[0]].float().cpu().numpy()
