"""Microsoft CLAP 2023 embedding model (`clap-2023`).

Port of ``fadtk_tpu/models/clap_ms.py`` (reference
fadtk/model_loader.py:463-522): 44.1 kHz input; a 7 s chunk at every 1 s hop
start, zero-padded to 7 s (:493-508; the int16 round-trip is commented out
upstream, :491); per chunk the msclap audio encoder, the HTSAT tower (tiny
geometry) and msclap's Projection head: 1024 features, not normalised
(``model.clap.audio_encoder(chunk)[0]``, :510).

The mel frontend (msclap's HTSAT config: n_fft 1024, hop 320, 64 slaney mels,
50-14000 Hz) is ``dsp/mel.py::torchlibrosa_log_mel``, always float32, one K3
launch per forward batch on the card. A converted checkpoint's ``__config__``
splits into mel fields and HTSAT fields, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from ..dsp.mel import torchlibrosa_log_mel
from ..utils import log, resolve_device
from .base import EmbeddingModel
from .htsat import HTSAT, HTSATConfig, htsat_forward, init_htsat_params, msclap_projection

_SR = 44100
_CHUNK = 7 * _SR
_HOP = _SR


class MelParams(NamedTuple):
    n_fft: int = 1024
    hop: int = 320
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0


def clap_ms_forward(module: HTSAT, mel: MelParams, chunks: torch.Tensor) -> torch.Tensor:
    """(B, 308700) float32 chunks -> (B, 1024) float32."""
    m = torchlibrosa_log_mel(chunks, sr=_SR, n_fft=mel.n_fft, hop=mel.hop, n_mels=mel.n_mels,
                             fmin=mel.fmin, fmax=mel.fmax)
    return msclap_projection(module, htsat_forward(module, m[:, None])).float()


class MSCLAPModel(EmbeddingModel):
    BATCH = 32  # 7 s chunks per device forward (cross-file)

    def __init__(self, type: str = "2023"):
        if type != "2023":
            raise ValueError("the reference registers only clap-2023")
        super().__init__(f"clap-{type}", 1024, _SR)
        self.type = type
        self.cfg = HTSATConfig(embed_dim=96)  # out_emb 768 == tiny geometry
        self.mel = MelParams()

    def weights_name(self) -> str:
        return "msclap_2023"

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
                fields = decode_config_meta(meta)
                self.mel = self.mel._replace(
                    **{k: v for k, v in fields.items() if k in MelParams._fields})
                self.cfg = replace(
                    self.cfg, **{k: v for k, v in fields.items() if k not in MelParams._fields})
            module = HTSAT(self.cfg, head="msclap", projection_dim=1024)
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning(f"{self.name}: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_htsat_params(HTSAT(self.cfg, head="msclap", projection_dim=1024),
                                       torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError(self.weights_name(), "msclap CLAP_weights_2023.pth")
        self.module = module.to(self.device)

    def _make_chunks(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        starts = range(0, audio.shape[0], _HOP)
        chunks = np.zeros((len(starts), _CHUNK), np.float32)
        for i, s in enumerate(starts):
            seg = audio[s : s + _CHUNK]
            chunks[i, : seg.shape[0]] = seg
        return chunks

    @torch.inference_mode()
    def _forward_chunks(self, chunks: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32)).to(self.device)
        return clap_ms_forward(self.module, self.mel, x).cpu().numpy()

    def _embed(self, audio: np.ndarray) -> np.ndarray:
        return self._forward_chunks(self._make_chunks(audio))

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file chunk batching (chunks are independent fixed windows);
        (n_chunks, 1024) float16 per clip, the cache format."""
        self.ensure_loaded()
        per_file = [self._make_chunks(np.asarray(c)) for c in clips]
        outs = self._batch_chunked(per_file, self._forward_chunks, batch_size=self.BATCH)
        return [o.astype(np.float16) for o in outs]

    def dp_spec(self):
        """Chunked device pipeline: the cached path's 7 s chunks (made on the
        host, a 1 s hop) are independent; K3 runs in each batch's frontend."""
        from ..parallel.dp import DpChunkSpec

        self.ensure_loaded()
        return DpChunkSpec(
            forward=lambda chunks: clap_ms_forward(self.module, self.mel, chunks),
            make_chunks=lambda clip: (self._make_chunks(clip),),
            num_features=self.num_features,
            preferred_batch=self.BATCH,
        )
