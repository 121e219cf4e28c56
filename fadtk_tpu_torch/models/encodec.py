"""EnCodec embedding models.

Port of ``fadtk_tpu/models/encodec.py`` (reference fadtk/model_loader.py:111-186):

- `encodec-emb` (24 kHz): mono, one pass of the SEANet encoder over the whole
  file at its exact length (the model is unsegmented, :135-137);
- `encodec-emb-48k` (48 kHz): stereo (mono is duplicated by convert_audio,
  :170), non-overlapping 1 s segments (stride == segment_length, :139-152),
  the full segments of a file batched together and the tail at its exact
  length.

Both cut audio at 3 minutes in load_wav (:172-174). Embeddings are the
continuous encoder latents (128 features), not quantized codes.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

from ..utils import log, resolve_device
from .base import EmbeddingModel, flatten_lstm_weights
from .encodec_impl import (
    CONFIG_24K,
    CONFIG_48K,
    EncodecEncoder,
    encodec_encode,
    init_encodec_params,
)


class EncodecEmbModel(EmbeddingModel):
    # Clips of one exact shape per forward on the 24k path: full-rate
    # activations are ~30 MB per 10 s clip, so an unbounded stack of a large
    # uniform-length dataset would not fit.
    GROUP_BATCH = 64

    def __init__(self, variant: str = "24k"):
        assert variant in ("24k", "48k")
        super().__init__(
            "encodec-emb" if variant == "24k" else f"encodec-emb-{variant}",
            128,
            sr=24000 if variant == "24k" else 48000,
        )
        self.variant = variant
        self.cfg = CONFIG_24K if variant == "24k" else CONFIG_48K
        self.segment_length = None if variant == "24k" else self.sr  # 1 s segments

    def weights_name(self) -> str:
        return f"encodec_{self.variant}"

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
            module = EncodecEncoder(self.cfg)
            module.load_state_dict(params_from_jax(stored, conv_layout="OIH"))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_encodec_params(EncodecEncoder(self.cfg), torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError(
                self.weights_name(), f"HF id facebook/encodec_{self.variant}hz"
            )
        # the LSTM's cuDNN weight buffer is laid out for this device
        self.module = flatten_lstm_weights(module.to(self.device))

    def load_wav(self, wav_file) -> np.ndarray:
        """Parity: fadtk/model_loader.py:165-176 — channel conversion (mono is
        duplicated for the stereo 48k model) and the 3-minute cut."""
        from ..audio.wavio import read_wav_int16

        data, _sr = read_wav_int16(wav_file)  # mono int16 from the convert cache
        return self.load_wav_array(data)

    def load_wav_array(self, wav_data: np.ndarray) -> np.ndarray:
        """In-memory twin of load_wav: /32768, channel duplication for the
        stereo 48k model, 3-minute cut. Returns (channels, T) float32."""
        wav = (np.asarray(wav_data, np.int16) / 32768.0).astype(np.float32)
        if wav.ndim == 1:
            wav = wav[None, :]
        if self.cfg.audio_channels == 2 and wav.shape[0] == 1:
            wav = np.repeat(wav, 2, axis=0)
        limit = 3 * 60 * self.sr
        if wav.shape[1] > limit:
            wav = wav[:, :limit]
        return wav

    @torch.inference_mode()
    def _forward(self, audio: np.ndarray) -> np.ndarray:
        """(B, channels, T) host audio -> (B, T_frames, 128) host float32."""
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        return encodec_encode(self.module, x).cpu().numpy()

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file batching for the 24k whole-file path: clips of identical
        (channels, length) share one forward, ``GROUP_BATCH`` at a time, each
        at its exact length (no padding, so the reflect padding is
        untouched). The 48k path embeds clip by clip; it batches the
        segments within a file."""
        if self.segment_length is not None:
            return super().embed_batch(clips)
        self.ensure_loaded()

        prepared = []
        for clip in clips:
            c = np.asarray(clip, np.float32)
            prepared.append(c[None, :] if c.ndim == 1 else c)

        groups: dict[tuple, list[int]] = defaultdict(list)
        for i, c in enumerate(prepared):
            groups[c.shape].append(i)

        results: list[np.ndarray | None] = [None] * len(clips)
        for idxs in groups.values():
            for start in range(0, len(idxs), self.GROUP_BATCH):
                part = idxs[start : start + self.GROUP_BATCH]
                out = self._forward(np.stack([prepared[i] for i in part])).astype(np.float16)
                for j, i in enumerate(part):
                    results[i] = out[j]
        return results  # type: ignore[return-value]

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]

        if self.segment_length is None:
            return self._forward(audio[None])[0]

        # 48k: non-overlapping 1 s segments; full segments batch together.
        seg = self.segment_length
        length = audio.shape[1]
        n_full = length // seg
        outs = []
        if n_full:
            stacked = audio[:, : n_full * seg].reshape(audio.shape[0], n_full, seg)
            outs.append(self._forward(np.moveaxis(stacked, 1, 0)))  # (n_full, C, seg)
        rem = length - n_full * seg
        if rem:
            outs.append(self._forward(audio[None, :, n_full * seg :]))
        return np.concatenate([o.reshape(-1, self.num_features) for o in outs], axis=0)
