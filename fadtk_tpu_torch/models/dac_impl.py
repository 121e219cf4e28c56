"""The Descript Audio Codec (DAC) encoder in PyTorch.

Port of ``fadtk_tpu/models/dac_impl.py``: descript-audio-codec's 44 kHz
encoder as the reference uses it (fadtk/model_loader.py:189-251), the
continuous pre-quantization latents.

Architecture (descript-audio-codec dac/model/dac.py):
    Encoder: WNConv1d(1, d, k7, p3)
             for each stride s in (2, 4, 8, 8):
                 EncoderBlock(d*2, s) = ResidualUnit(d, dil 1, 3, 9) x3,
                                        Snake1d(d), WNConv1d(d, 2d, k=2s, s, p=ceil(s/2))
             Snake1d, WNConv1d(1024, latent_dim=1024, k3, p1)
    ResidualUnit(d, dil): Snake1d -> WNConv1d(d, d, k7, dil, p=3*dil) ->
                          Snake1d -> WNConv1d(d, d, k1); residual add.
    Snake activation: x + sin(alpha x)^2 / (alpha + 1e-9), per-channel alpha.

Weight-normed convs are materialized at conversion; the module tree mirrors
the JAX parameter tree, conv weights in PyTorch's (C_out, C_in, K) order
(``params_from_jax(tree, conv_layout="OIH")``). All padding is symmetric zero
padding, so the 5 s windows batch into one forward. Snake uses ``torch.sin``
(the JAX package's Cody-Waite polynomial is a TPU workaround, not ported).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .encodec_impl import Conv


@dataclass(frozen=True)
class DACEncoderConfig:
    d_model: int = 64
    strides: tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 1024  # encoder_dim * 2**len(strides) for the 44k model

    @property
    def hop_length(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out


DAC_44K = DACEncoderConfig()


class ResidualUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.alpha1 = nn.Parameter(torch.ones(dim))
        self.conv1 = Conv(dim, dim, 7)
        self.alpha2 = nn.Parameter(torch.ones(dim))
        self.conv2 = Conv(dim, dim, 1)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.res = nn.ModuleList([ResidualUnit(dim) for _ in range(3)])
        self.alpha = nn.Parameter(torch.ones(dim))
        self.down = Conv(dim, dim * 2, 2 * stride)


class DACEncoder(nn.Module):
    """Parameter tree of the DAC encoder; the forward is ``dac_encode``."""

    def __init__(self, cfg: DACEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv(1, cfg.d_model, 7)
        d = cfg.d_model
        blocks = []
        for stride in cfg.strides:
            blocks.append(EncoderBlock(d, stride))
            d *= 2
        self.blocks = nn.ModuleList(blocks)
        self.alpha_out = nn.Parameter(torch.ones(d))
        self.conv_out = Conv(d, cfg.latent_dim, 3)


def _snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x: (B, C, T); alpha: (C,): x + reciprocal(alpha + 1e-9) * sin(alpha x)^2,
    the reciprocal-multiply form descript-audio-codec computes."""
    a = alpha[None, :, None]
    inv = 1.0 / (alpha + 1e-9)
    return x + inv[None, :, None] * torch.sin(a * x).square()


def _conv(p: Conv, x: torch.Tensor, stride: int = 1, dilation: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv1d(x, p.weight, p.bias, stride=stride, padding=padding, dilation=dilation)


def _residual_unit(p: ResidualUnit, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = _snake(x, p.alpha1)
    y = _conv(p.conv1, y, dilation=dilation, padding=3 * dilation)
    y = _snake(y, p.alpha2)
    y = _conv(p.conv2, y)
    pad = (x.shape[-1] - y.shape[-1]) // 2
    if pad > 0:
        x = x[..., pad:-pad]
    return x + y


def dac_encode(model: DACEncoder, audio: torch.Tensor) -> torch.Tensor:
    """(B, 1, T) -> (B, T_frames, latent_dim) float32 latents.

    Compute follows the weight dtype; the audio moves to the weights' device
    and dtype.
    """
    w = model.conv_in.weight
    x = _conv(model.conv_in, audio.to(device=w.device, dtype=w.dtype), padding=3)
    for block, stride in zip(model.blocks, model.cfg.strides):
        for unit, dil in zip(block.res, (1, 3, 9)):
            x = _residual_unit(unit, x, dil)
        x = _snake(x, block.alpha)
        x = _conv(block.down, x, stride=stride, padding=math.ceil(stride / 2))
    x = _snake(x, model.alpha_out)
    x = _conv(model.conv_out, x, padding=1)
    return x.transpose(1, 2).float()


@torch.no_grad()
def init_dac_params(model: DACEncoder, generator: torch.Generator) -> DACEncoder:
    """Random weights in the JAX package's scheme: conv kernels
    U(±1/√(k·C_in)); biases 0 and snake alphas 1 as constructed."""
    for m in model.modules():
        if isinstance(m, Conv):
            cout, cin, k = m.weight.shape
            s = 1.0 / math.sqrt(k * cin)
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * (2 * s) - s)
    return model
