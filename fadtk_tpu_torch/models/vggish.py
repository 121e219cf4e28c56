"""VGGish embedding model.

Port of ``fadtk_tpu/models/vggish.py`` (reference fadtk/model_loader.py:89-108):
torch.hub harritaylor/torchvggish with PCA postprocessing disabled and the
final ReLU stripped from the embedding head, so the embedding is the raw
128-d output of the last linear layer. 16 kHz, min_len = 1 s.

Architecture (VGG on (96, 64) log-mel examples):
    conv3x3(64) - pool - conv3x3(128) - pool - conv3x3(256) x2 - pool -
    conv3x3(512) x2 - pool -> (512, 6, 4) -> flatten in (h, w, c) order ->
    fc 4096 - relu - fc 4096 - relu - fc 128.

The port runs NCHW, PyTorch's layout; the JAX package's NHWC flatten order
(h, w, c) is kept by permuting before the flatten, so a converted fc1 kernel
maps as it is. Each 0.96 s example is an independent batch element; the
frontend (``dsp/mel.py::vggish_log_mel_examples``) runs on the model's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.mel import vggish_log_mel_examples
from ..utils import log, resolve_device
from .base import EmbeddingModel

_CONV_CHANNELS = (64, 128, 256, 256, 512, 512)
_POOL_AFTER = {0, 1, 3, 5}  # pool after these conv indices


class VGGish(nn.Module):
    """Parameter tree of the JAX package's VGGish: ``features`` (six 3x3
    convs), ``fc1``..``fc3``; the forward is ``vggish_forward``."""

    def __init__(self):
        super().__init__()
        chans = (1, *_CONV_CHANNELS)
        self.features = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1) for cin, cout in zip(chans, chans[1:]))
        self.fc1 = nn.Linear(512 * 6 * 4, 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, 128)


def vggish_forward(model: VGGish, examples: torch.Tensor) -> torch.Tensor:
    """(N, 96, 64) log-mel examples -> (N, 128) float32 embeddings.

    Compute follows the weights' dtype; the examples move to the weights'
    device and dtype.
    """
    w = model.fc1.weight
    x = examples.to(device=w.device, dtype=w.dtype)[:, None]  # NCHW
    for i, conv in enumerate(model.features):
        x = F.relu(conv(x))
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), the JAX NHWC order
    x = F.relu(model.fc1(x))
    x = F.relu(model.fc2(x))
    # Final ReLU intentionally absent (reference strips it, model_loader.py:102-103).
    return model.fc3(x).float()


@torch.no_grad()
def init_vggish_params(model: VGGish, generator: torch.Generator) -> VGGish:
    """Random weights in the JAX package's scheme: conv and dense kernels
    U(±1/√fan_in), biases 0. A torch.Generator gives other numbers than a
    jax key from the same seed."""

    def uniform(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * s) - s)

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            uniform(m.weight, 1.0 / math.sqrt(9 * m.in_channels))
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            uniform(m.weight, 1.0 / math.sqrt(m.in_features))
            m.bias.zero_()
    return model


class VGGishModel(EmbeddingModel):
    """The reference registry's only configuration: no PCA, no final
    activation (fadtk/model_loader.py:676-701)."""

    # 0.96 s examples per device forward, across files.
    EXAMPLE_BATCH = 256

    def __init__(self):
        super().__init__("vggish", 128, 16000, min_len=1)

    def load_model(self) -> None:
        from ..weights.store import (
            MissingWeightsError,
            load_params,
            params_from_jax,
            params_path,
            random_weights_enabled,
        )

        self.device = resolve_device()
        path = params_path("vggish")
        if path.exists():
            stored = load_params(path)
            stored.pop("__config__", None)
            module = VGGish()
            module.load_state_dict(params_from_jax(stored))
        elif random_weights_enabled():
            log.warning("vggish: using RANDOM weights (FADTK_TPU_RANDOM_WEIGHTS=1)")
            module = init_vggish_params(VGGish(), torch.Generator().manual_seed(0))
        else:
            raise MissingWeightsError("vggish", "torch.hub harritaylor/torchvggish")
        self.module = module.to(self.device)

    def _examples(self, audio: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
        return vggish_log_mel_examples(x)

    @torch.inference_mode()
    def _embed(self, audio: np.ndarray) -> np.ndarray:
        examples = self._examples(audio)
        if examples.shape[0] == 0:
            return np.zeros((0, 128), np.float32)
        return vggish_forward(self.module, examples).cpu().numpy()

    @torch.inference_mode()
    def embed_batch(self, clips: list[np.ndarray]) -> list[np.ndarray]:
        """Cross-file example batching: every file's examples are made on the
        device and go through the network ``EXAMPLE_BATCH`` at a time (the
        last batch is not padded). Returns float16 arrays (the cache format)."""
        self.ensure_loaded()
        per_file = [self._examples(c) for c in clips]
        flat = torch.cat(per_file)
        outs = [vggish_forward(self.module, flat[i : i + self.EXAMPLE_BATCH])
                for i in range(0, flat.shape[0], self.EXAMPLE_BATCH)]
        merged = torch.cat(outs).to(torch.float16).cpu().numpy()
        return np.split(merged, np.cumsum([e.shape[0] for e in per_file])[:-1])

    def dp_spec(self):
        """Chunked device pipeline: the 0.96 s log-mel examples (made on the
        model's device, as for the cached path, and handed over on the host)
        are independent batch rows."""
        from ..parallel.dp import DpChunkSpec

        self.ensure_loaded()

        @torch.inference_mode()
        def make_chunks(clip):
            return (self._examples(clip).cpu().numpy(),)

        return DpChunkSpec(
            forward=lambda examples: vggish_forward(self.module, examples),
            make_chunks=make_chunks,
            num_features=self.num_features,
            preferred_batch=self.EXAMPLE_BATCH,
        )
