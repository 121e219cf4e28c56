"""Base class for embedding models.

Contract parity with the reference's ``ModelLoader`` (reference
fadtk/model_loader.py:21-86) and with ``fadtk_tpu.models.base``: a model has a
unique ``name``, an output feature dimension, an input sample rate and an
optional minimum length; it loads lazily; ``get_embedding`` returns a float16
``(n_frames, num_features)`` array for storage (the float32 -> float16
downcast at fadtk/model_loader.py:47-48 is part of the on-disk cache format).

Torch specifics: the weights live in ``self.module`` (an ``nn.Module``) on
``self.device``, which is chosen once at load (``utils.resolve_device``) and
passed down to every tensor the model makes.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import linear_f32 as k6
from ..runner import profiling
from ..utils import PathLike, log


def flatten_lstm_weights(module: torch.nn.Module) -> torch.nn.Module:
    """Lay every ``nn.LSTM``'s weights of ``module`` out as one contiguous
    cuDNN buffer; call after any ``.to(dtype)`` or ``.to(device)``.

    ``nn.LSTM.flatten_parameters`` skips bfloat16 weights (its
    ``cudnn.is_acceptable`` check lists float16/32/64 only) although cuDNN's
    RNN runs them; left scattered, every forward warns "RNN module weights
    are not part of single contiguous chunk of memory" and copies them into a
    new buffer. For bf16 this does what ``flatten_parameters`` does for the
    other types. A no-op off the card."""
    for m in module.modules():
        if not isinstance(m, torch.nn.LSTM):
            continue
        m.flatten_parameters()
        w = m._flat_weights
        if not (w and w[0].is_cuda and w[0].dtype == torch.bfloat16
                and torch.backends.cudnn.enabled and torch.backends.cudnn.is_available()
                and torch._use_cudnn_rnn_flatten_weight()):
            continue
        if len({p.data_ptr() for p in w}) != len(w) or m.proj_size:
            continue
        import torch.backends.cudnn.rnn as cudnn_rnn

        with torch.cuda.device_of(w[0]), torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                w, 4 if m.bias else 2, m.input_size, cudnn_rnn.get_cudnn_mode(m.mode),
                m.hidden_size, m.proj_size, m.num_layers, m.batch_first,
                bool(m.bidirectional))
    return module


def cast_module(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """``module.to(dtype)`` with its LSTM weights re-flattened."""
    return flatten_lstm_weights(module.to(dtype))


def linear(lin: torch.nn.Linear, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    """``lin(x)`` (without its bias if not ``bias``) for a model's projection:
    the one point that routes the speech encoders' and Whisper's
    projections. A float32 product on the card with enough rows
    (``ops.linear_f32.takes``) goes to the 3xTF32 kernel K6, anything else
    (the CPU, bf16, Whisper's 2-token decoder rows, WavLM's 8-wide gate) to
    ``F.linear``. Counted, from shapes, as ``model.linear_kernel_flop`` or
    ``model.linear_plain_flop`` (2·M·N·K)."""
    weight, b = lin.weight, lin.bias if bias else None
    n, k = weight.shape
    flop = 2 * (x.numel() // k) * n * k
    if k6.takes(x, weight):
        profiling.count("model.linear_kernel_flop", flop)
        return k6.linear_f32(x, weight, b)
    profiling.count("model.linear_plain_flop", flop)
    return F.linear(x, weight, b)


def row_sharded_linear(lin: torch.nn.Linear, x: torch.Tensor, group=None) -> torch.Tensor:
    """``lin(x)`` for a projection whose input features are split over the
    tensor-parallel ``group`` (the row-parallel cut of ``parallel/``): the
    ranks' partial products are summed over the group, then the whole bias
    is added once. Without a group (one rank), the plain fused-bias call.
    Both go through ``linear``."""
    if group is None:
        return linear(lin, x)
    y = linear(lin, x, bias=False)
    dist.all_reduce(y, group=group)
    return y + lin.bias


class EmbeddingModel(ABC):
    """One embedding model variant (one registry name)."""

    def __init__(self, name: str, num_features: int, sr: int, min_len: int = -1):
        self.name = name
        self.num_features = num_features
        self.sr = sr
        self.min_len = min_len
        self.loaded = False
        self.module: torch.nn.Module | None = None
        self.device: torch.device | None = None
        self._bf16_active: bool | None = None  # latched at first ensure_loaded

    # ------------------------------------------------------------------ #
    # Loading / precision
    # ------------------------------------------------------------------ #

    @abstractmethod
    def load_model(self) -> None:
        """Materialize ``self.module`` on ``self.device`` (converted checkpoint
        or random weights for tests)."""

    @property
    def bf16(self) -> bool:
        """Is the bf16 throughput mode active for this model (models/precision.py)?

        Latched at first ``ensure_loaded``: once the module is cast (or loaded
        float32), flipping FADTK_TPU_BF16 cannot desynchronize the compute
        dtype from ``cache_name``.
        """
        if self._bf16_active is not None:
            return self._bf16_active
        from .precision import bf16_enabled

        return bf16_enabled()

    @property
    def cache_name(self) -> str:
        """Name keying embedding/stats caches. bf16-mode embeddings differ
        numerically from the float32 reference-parity ones, so they live under
        a distinct ``<name>-bf16`` cache and can never mix."""
        return f"{self.name}-bf16" if self.bf16 else self.name

    def ensure_loaded(self) -> None:
        if self.loaded:
            return
        self._bf16_active = self.bf16  # latch the mode with the weights
        if not self._bf16_active:
            # float32 is the parity path: cuDNN convolutions default to TF32
            # (~3 significant digits, and the conv extractor is 7 convs deep),
            # so TF32 goes off for convolutions and matmuls alike, once, here
            # where the float32 model loads.
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.load_model()
        self.module.eval()
        if self._bf16_active:
            cast_module(self.module, torch.bfloat16)  # compute dtype follows the weights
            log.info(f"{self.name}: bf16 throughput mode (weights cast to bfloat16)")
        self.loaded = True

    # ------------------------------------------------------------------ #
    # Audio input
    # ------------------------------------------------------------------ #

    def load_wav(self, wav_file: PathLike) -> np.ndarray:
        """Read a converted 16-bit PCM wav as float in [-1, 1).

        Parity: reference fadtk/model_loader.py:63-70 (int16 / 32768, then
        minimum-length zero padding).
        """
        from ..audio.wavio import read_wav_int16

        wav_data, _sr = read_wav_int16(wav_file)
        if wav_data.ndim == 2:  # (frames, channels) -> keep channel-major parity
            wav_data = wav_data.astype(np.float64)
        wav = wav_data / 32768.0
        return self.enforce_min_len(wav)

    def load_wav_array(self, wav_data: np.ndarray) -> np.ndarray:
        """In-memory twin of ``load_wav``: consume the int16 PCM that *would*
        have been written to the convert cache (same content, no file). Used
        by the device pipeline's in-memory convert (runner/convert.py).
        Overrides must mirror their ``load_wav``."""
        wav = np.asarray(wav_data, np.int16) / 32768.0
        return self.enforce_min_len(wav)

    def enforce_min_len(self, audio: np.ndarray) -> np.ndarray:
        """Zero-pad audio shorter than ``min_len`` seconds, with a warning.

        Parity: reference fadtk/model_loader.py:72-86.
        """
        if self.min_len < 0:
            return audio
        if audio.shape[0] < self.min_len * self.sr:
            log.warning(
                f"Audio is too short for {self.name}. The model requires a minimum "
                f"length of {self.min_len}s, audio is {audio.shape[0] / self.sr:.2f}s. "
                "Padding with zeros."
            )
            pad = int(np.ceil(self.min_len * self.sr - audio.shape[0]))
            audio = np.pad(audio, (0, pad))
        return audio

    # ------------------------------------------------------------------ #
    # Embedding
    # ------------------------------------------------------------------ #

    @abstractmethod
    def _embed(self, audio: np.ndarray) -> np.ndarray:
        """Embed one clip -> (n_frames, num_features)."""

    def get_embedding(self, audio: np.ndarray) -> np.ndarray:
        """Embed and downcast for storage (parity: fadtk/model_loader.py:40-50)."""
        self.ensure_loaded()
        embd = np.asarray(self._embed(audio))
        if embd.dtype == np.float32:
            embd = embd.astype(np.float16)
        return embd

    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Embed several clips; subclasses override with batched device code."""
        return [self.get_embedding(c) for c in clips]

    def dp_spec(self):
        """Plug into the chunked device pipeline (``parallel/dp.py``): families
        whose inference is a fixed-window forward return a ``DpChunkSpec``.
        Default: None."""
        return None

    def dp_whole_spec(self):
        """Plug into the whole-clip device pipeline (``parallel/dp.py``) for
        families with no static window that are per-clip independent at exact
        length (encodec-emb 24k): a ``DpWholeClipSpec``. Default: None."""
        return None

    @staticmethod
    def _batch_chunked(
        per_file_chunks: list[np.ndarray],
        forward,
        batch_size: int = 32,
    ) -> list[np.ndarray]:
        """Cross-file batching helper for fixed-window ("chunked") models.

        per_file_chunks: one (n_chunks_i, *chunk_shape) array per file — all
        chunk shapes equal. Chunks from all files concatenate into device
        batches of ``batch_size`` (the last one zero-padded to the full size,
        the padded rows dropped), then split back per file. Chunk-level
        results are independent per sample, so batching is exact.
        """
        counts = [c.shape[0] for c in per_file_chunks]
        flat = np.concatenate(per_file_chunks, axis=0)
        total = flat.shape[0]
        if total == 0:
            return [c[:0] for c in per_file_chunks]
        outs = []
        for start in range(0, total, batch_size):
            group = flat[start : start + batch_size]
            pad = batch_size - group.shape[0]
            if pad:
                group = np.concatenate([group, np.zeros((pad, *group.shape[1:]), group.dtype)])
            out = np.asarray(forward(group))
            outs.append(out[: out.shape[0] - pad] if pad else out)
        merged = np.concatenate(outs, axis=0)
        results, pos = [], 0
        for n in counts:
            results.append(merged[pos : pos + n])
            pos += n
        return results

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name} d={self.num_features} sr={self.sr}>"
