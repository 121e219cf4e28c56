"""CDPAM base encoder as an ``nn.Module``.

Port of ``fadtk_tpu/models/cdpam_impl.py``: the ``base_encoder`` ("lossnet")
of the CDPAM perceptual metric (pranaymanocha/PerceptualAudio), as the
reference calls it (fadtk/model_loader.py:437-445):

    _, acoustic, content = model.model.base_encoder.forward(chunk.unsqueeze(1))

on a (batch, 1, samples) waveform at int16 scale, returning the 512-d
acoustic and content embeddings. The architecture is the JAX package's
reconstruction (its provenance note applies here unchanged): 16 strided
``Conv1d`` layers (kernel 3, stride 2, zero "same" padding; channels 64x5,
128x5, 256x5, 512), each followed by BatchNorm with inference statistics and
LeakyReLU 0.2, a mean pool over time and two linear heads. A converted
checkpoint stores its inferred geometry in ``__config__``, which
``CdpamModel.load_model`` applies.

Chunks pad to ``chunk_samples`` with a valid sample count; every layer zeroes
the frames past the valid length (``n -> ceil(n / stride)``) and the pool
divides by the true frame count, so a padded batch equals each ragged chunk
run alone.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class CdpamConfig:
    channels: tuple = (64,) * 5 + (128,) * 5 + (256,) * 5 + (512,)
    kernel_size: int = 3
    stride: int = 2
    emb_dim: int = 512
    leaky_slope: float = 0.2
    bn_eps: float = 1e-5
    chunk_samples: int = 22050  # 1 s at 22.05 kHz (fadtk/model_loader.py:438)


DEFAULT_CONFIG = CdpamConfig()


class BatchNormStats(nn.Module):
    """Inference BatchNorm's four vectors under the JAX tree's names
    (``scale`` maps to ``weight`` in ``params_from_jax``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.mean = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.var = nn.Parameter(torch.ones(channels), requires_grad=False)


class CdpamEncoder(nn.Module):
    """Parameter tree of the JAX package's CDPAM: ``convs``, ``norms``,
    ``acoustic``, ``content``; the forward is ``cdpam_forward``."""

    def __init__(self, cfg: CdpamConfig = DEFAULT_CONFIG):
        super().__init__()
        self.cfg = cfg
        chans = (1, *cfg.channels)
        pad = (cfg.kernel_size - 1) // 2
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, cout, cfg.kernel_size, stride=cfg.stride, padding=pad)
            for cin, cout in zip(chans, chans[1:]))
        self.norms = nn.ModuleList(BatchNormStats(c) for c in cfg.channels)
        self.acoustic = nn.Linear(chans[-1], cfg.emb_dim)
        self.content = nn.Linear(chans[-1], cfg.emb_dim)


def cdpam_forward(model: CdpamEncoder, chunks: torch.Tensor, lengths: torch.Tensor):
    """(B, chunk_samples) int16-scale chunks, zero past each chunk's valid
    length, and (B,) valid sample counts -> (features, acoustic, content),
    (B, C_last), (B, emb_dim), (B, emb_dim) float32. Compute follows the
    weights' dtype; the inputs move to the weights' device."""
    cfg = model.cfg
    w = model.acoustic.weight
    x = chunks.to(device=w.device, dtype=w.dtype)[:, None, :]  # (B, 1, T)
    n = lengths.to(device=w.device, dtype=torch.int64)
    for conv, bn in zip(model.convs, model.norms):
        x = conv(x)
        # The JAX package's arithmetic, (x - mean) * (rsqrt(var + eps) * scale) + bias.
        inv = torch.rsqrt(bn.var + cfg.bn_eps)
        x = (x - bn.mean[:, None]) * (inv * bn.weight)[:, None] + bn.bias[:, None]
        x = torch.where(x >= 0, x, cfg.leaky_slope * x)
        # Valid-length chain: conv1d(k odd, p = (k-1)//2) maps T -> ceil(T / stride).
        n = -(-n // cfg.stride)
        mask = torch.arange(x.shape[-1], device=x.device)[None, :] < n[:, None]
        x = x * mask[:, None, :].to(x.dtype)
    feats = x.sum(dim=-1) / n.clamp(min=1)[:, None].to(x.dtype)
    acoustic = model.acoustic(feats)
    content = model.content(feats)
    return feats.float(), acoustic.float(), content.float()


def l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(v, dim=1)`` semantics: v / max(||v||_2, eps)."""
    norm = torch.sqrt((v * v).sum(dim=1, keepdim=True))
    return v / norm.clamp(min=eps)


@torch.no_grad()
def init_cdpam_params(model: CdpamEncoder, generator: torch.Generator) -> CdpamEncoder:
    """Random weights in the JAX package's scheme: conv kernels
    U(±1/√(k·C_in)) with zero biases, running variances 1 + 0.1·U(0, 1)
    (spread, so a forward that ignores them is caught), heads U(±1/√C_in).
    A torch.Generator gives other numbers than a jax key from the same seed."""

    def uniform(t: torch.Tensor, lo: float, hi: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    for conv, bn in zip(model.convs, model.norms):
        s = 1.0 / math.sqrt(conv.kernel_size[0] * conv.in_channels)
        uniform(conv.weight, -s, s)
        conv.bias.zero_()
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.mean.zero_()
        uniform(bn.var, 1.0, 1.1)
    for head in (model.acoustic, model.content):
        s = 1.0 / math.sqrt(head.in_features)
        uniform(head.weight, -s, s)
        uniform(head.bias, -s, s)
    return model

