"""CDPAM perceptual embeddings (`cdpam-acoustic`, `cdpam-content`).

Port of ``fadtk_tpu/models/cdpam.py`` (reference fadtk/model_loader.py:421-460):
22.05 kHz input, 1 s non-overlapping chunks (the trailing partial chunk runs
at its own length, :438-441), the CDPAM base encoder's acoustic or content
head, L2-normalised per chunk (:443-444), concatenated to (n_chunks, 512).

The reference's ``load_wav`` (:451-460) reads floats and multiplies by 32768,
so the network consumes int16-scale values; the converted cache wav is
int16 already, so ``load_wav`` skips the /32768. Both modes are heads on one
checkpoint (``weights_name`` "cdpam"). The encoder is the JAX package's
reconstruction (``cdpam_impl.py``); a converted checkpoint's ``__config__``
adapts its geometry.

Chunks of every file go through the network in padded batches of
``CHUNK_BATCH``; per-layer valid-length masking makes a padded chunk equal
its exact-length run, and pad rows get length 1.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..utils import PathLike, log, resolve_device
from .base import EmbeddingModel
from .cdpam_impl import (
    DEFAULT_CONFIG,
    CdpamEncoder,
    cdpam_forward,
    init_cdpam_params,
    l2_normalize,
)


class CdpamModel(EmbeddingModel):
    # 1 s chunks per device forward (cross-file); the narrow conv stack
    # needs a deep batch.
    CHUNK_BATCH = 128

    def __init__(self, mode: str):
        if mode not in ("acoustic", "content"):
            raise ValueError("Mode must be 'acoustic' or 'content'")
        super().__init__(f"cdpam-{mode}", 512, 22050)
        self.mode = mode
        self.cfg = DEFAULT_CONFIG

    def weights_name(self) -> str:
        # Both modes are heads on one shared base_encoder checkpoint.
        return "cdpam"

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
            module = CdpamEncoder(self.cfg)
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_cdpam_params(CdpamEncoder(self.cfg), torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError(
                self.weights_name(),
                "cdpam pip package checkpoint scratch_loss_*.pth "
                "(pranaymanocha/PerceptualAudio)",
            )
        self.module = module.to(self.device)

    def load_wav(self, wav_file: PathLike) -> np.ndarray:
        """int16-scale float32, the reference's x*32768 round-trip
        (fadtk/model_loader.py:451-460)."""
        from ..audio.wavio import read_wav_int16

        wav_data, _sr = read_wav_int16(wav_file)
        return wav_data.astype(np.float32)

    def load_wav_array(self, wav_data: np.ndarray) -> np.ndarray:
        """In-memory twin of load_wav: int16-scale float32."""
        return np.asarray(wav_data, np.int16).astype(np.float32)

    def _chunk(self, audio: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One clip -> zero-padded 1 s chunks and their valid lengths, at the
        reference's range(0, len, sr) boundaries (fadtk/model_loader.py:438-441)."""
        size = self.cfg.chunk_samples
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = -(-audio.shape[0] // size)
        chunks = np.zeros((n, size), np.float32)
        lengths = np.zeros((n,), np.int32)
        for j, i in enumerate(range(0, audio.shape[0], size)):
            c = audio[i : i + size]
            chunks[j, : c.shape[0]] = c
            lengths[j] = c.shape[0]
        return chunks, lengths

    def _head(self, chunks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, chunk) chunks and (B,) lengths on any device -> (B, 512)
        L2-normalised float32 on the model's device."""
        _, acoustic, content = cdpam_forward(self.module, chunks, lengths)
        return l2_normalize(acoustic if self.mode == "acoustic" else content)

    @torch.inference_mode()
    def _forward_padded(self, chunks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """(n, chunk) host chunks -> (n, 512) host float32, ``CHUNK_BATCH``
        rows per forward; the last batch's pad rows get length 1."""
        outs = []
        for start in range(0, chunks.shape[0], self.CHUNK_BATCH):
            g = chunks[start : start + self.CHUNK_BATCH]
            gl = lengths[start : start + self.CHUNK_BATCH]
            pad = self.CHUNK_BATCH - g.shape[0]
            if pad:
                g = np.concatenate([g, np.zeros((pad, g.shape[1]), g.dtype)])
                gl = np.concatenate([gl, np.ones((pad,), gl.dtype)])
            out = self._head(torch.from_numpy(g).to(self.device),
                             torch.from_numpy(gl).to(self.device)).cpu().numpy()
            outs.append(out[: out.shape[0] - pad] if pad else out)
        return np.concatenate(outs, axis=0)

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        chunks, lengths = self._chunk(audio)
        if chunks.shape[0] == 0:
            return np.zeros((0, self.num_features), np.float32)
        return self._forward_padded(chunks, lengths)

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file chunk batching (1 s chunks are independent); (n_chunks,
        512) float16 per clip, the cache format."""
        self.ensure_loaded()
        per_file = [self._chunk(c) for c in clips]
        counts = [c.shape[0] for c, _ in per_file]
        if sum(counts) == 0:
            return [np.zeros((0, self.num_features), np.float16) for _ in clips]
        merged = self._forward_padded(np.concatenate([c for c, _ in per_file]),
                                      np.concatenate([n for _, n in per_file]))
        return np.split(merged.astype(np.float16), np.cumsum(counts)[:-1])

    def dp_spec(self):
        """Chunked device pipeline: 1 s chunks and their valid lengths."""
        from ..parallel.dp import DpChunkSpec

        self.ensure_loaded()
        return DpChunkSpec(
            forward=self._head,
            make_chunks=self._chunk,
            num_features=self.num_features,
            preferred_batch=256,  # 1 s chunks, narrow channels (the JAX package's)
        )
