"""LAION-CLAP embedding models (`clap-laion-audio`, `clap-laion-music`).

Port of ``fadtk_tpu/models/clap_laion.py`` (reference
fadtk/model_loader.py:291-418): 48 kHz input; the int16 quantize round-trip
(:392-393,413-418); a 10 s chunk at every 1 s hop start, tails zero-padded to
10 s (a 10 s clip gives 10 embedding frames, :395-404); per chunk the HTSAT
audio tower (tiny for 'audio', base for 'music', :385), the MLP projection
and L2 normalisation: 512 features.

The mel frontend (torchlibrosa: n_fft 1024, hop 480, 64 slaney mels,
50-14000 Hz) is ``dsp/mel.py::torchlibrosa_log_mel``, always float32 (also
under ``--bf16``), one K3 launch per forward batch on the card. Chunks of
several files share forwards of 32 (``EmbeddingModel._batch_chunked``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..dsp.mel import torchlibrosa_log_mel
from ..utils import log, resolve_device
from .base import EmbeddingModel
from .htsat import (
    HTSAT,
    HTSAT_BASE,
    HTSAT_TINY,
    clap_audio_projection,
    htsat_forward,
    init_htsat_params,
)

_SR = 48000
_CHUNK = 10 * _SR
_HOP = _SR
_MEL = dict(sr=_SR, n_fft=1024, hop=480, n_mels=64, fmin=50.0, fmax=14000.0)


def clap_laion_forward(module: HTSAT, chunks: torch.Tensor) -> torch.Tensor:
    """(B, 480000) float32 chunks -> (B, 512) L2-normalised float32: the
    float32 frontend, the tower and projection in the weights' dtype, the
    normalisation in float32."""
    mel = torchlibrosa_log_mel(chunks, **_MEL)  # (B, 1001, 64)
    proj = clap_audio_projection(module, htsat_forward(module, mel[:, None])).float()
    return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True)


class CLAPLaionModel(EmbeddingModel):
    BATCH = 32  # 10 s chunks per device forward (cross-file)

    def __init__(self, type: str):
        if type not in ("audio", "music"):
            raise ValueError(f"unknown clap-laion type {type!r}")
        super().__init__(f"clap-laion-{type}", 512, _SR)
        self.type = type
        self.cfg = HTSAT_TINY if type == "audio" else HTSAT_BASE

    def weights_name(self) -> str:
        return f"clap_laion_{self.type}"

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
            module = HTSAT(self.cfg, head="laion")
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_htsat_params(HTSAT(self.cfg, head="laion"),
                                       torch.Generator().manual_seed(0))
        else:
            ckpt = ("630k-audioset-best.pt" if self.type == "audio"
                    else "music_audioset_epoch_15_esc_90.14.pt")
            raise MissingWeightsError(self.weights_name(), f"laion_clap checkpoint {ckpt}")
        self.module = module.to(self.device)

    @staticmethod
    def _quantize_roundtrip(x: np.ndarray) -> np.ndarray:
        """int16 round-trip (parity: fadtk/model_loader.py:392-393,413-418)."""
        q = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
        return (q / 32767.0).astype(np.float32)

    def _make_chunks(self, audio: np.ndarray) -> np.ndarray:
        """(n,) audio -> (n_chunks, 480000): the quantize round-trip, then a
        chunk at every hop start with zero-padded tails."""
        audio = self._quantize_roundtrip(np.asarray(audio, dtype=np.float64).reshape(-1))
        starts = range(0, audio.shape[0], _HOP)
        chunks = np.zeros((len(starts), _CHUNK), np.float32)
        for i, s in enumerate(starts):
            seg = audio[s : s + _CHUNK]
            chunks[i, : seg.shape[0]] = seg
        return chunks

    @torch.inference_mode()
    def _forward_chunks(self, chunks: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32)).to(self.device)
        return clap_laion_forward(self.module, x).cpu().numpy()

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        return self._forward_chunks(self._make_chunks(audio))

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file chunk batching (chunks are independent fixed windows);
        (n_chunks, 512) float16 per clip, the cache format."""
        self.ensure_loaded()
        per_file = [self._make_chunks(np.asarray(c)) for c in clips]
        outs = self._batch_chunked(per_file, self._forward_chunks, batch_size=self.BATCH)
        return [o.astype(np.float16) for o in outs]

    def dp_spec(self):
        """Chunked device pipeline: the cached path's 10 s chunks (made on the
        host, a 1 s hop) are independent; K3 runs in each batch's frontend."""
        from ..parallel.dp import DpChunkSpec

        self.ensure_loaded()
        return DpChunkSpec(
            forward=lambda chunks: clap_laion_forward(self.module, chunks),
            make_chunks=lambda clip: (self._make_chunks(clip),),
            num_features=self.num_features,
            preferred_batch=self.BATCH,
        )
