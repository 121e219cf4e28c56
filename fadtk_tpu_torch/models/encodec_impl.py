"""The EnCodec SEANet encoder in PyTorch.

Port of ``fadtk_tpu/models/encodec_impl.py``: the continuous (pre-quantizer)
encoder latents the reference extracts with ``model.encoder(audio)``
(reference fadtk/model_loader.py:154-163), with HF transformers' EncodecModel
semantics:

- convs with causal (24k) or asymmetric (48k) 'same'-style padding, including
  the ceil-to-full-frames extra right padding, reflect mode with the
  small-input guard;
- weight norm (24k, materialized at conversion) or time group norm (48k);
- ELU activations, residual blocks with conv shortcuts; the 24k blocks take
  the fused kernel (``ops/fused_resnet.py``) under ``FADTK_TPU_FUSED_RESNET``;
- a 2-layer LSTM (``nn.LSTM``, gate order i, f, g, o) with a skip connection
  before the final projection.

The module tree mirrors the JAX parameter tree and HF's layer indices
(``layers["<hf index>"]``), conv weights in PyTorch's (C_out, C_in, K) order,
so a converted ``.npz`` maps one to one
(``weights/store.py::params_from_jax(tree, conv_layout="OIH")``). Layout is
NCT throughout, x: (B, C, T); the model classes feed exact-length audio, so
the reflect padding sees the true signal tail.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class EncodecEncoderConfig:
    audio_channels: int = 1
    num_filters: int = 32
    upsampling_ratios: tuple[int, ...] = (8, 5, 4, 2)
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    compress: int = 2
    hidden_size: int = 128
    num_lstm_layers: int = 2
    use_causal_conv: bool = True
    norm_type: str = "weight_norm"  # or "time_group_norm"
    pad_mode: str = "reflect"
    use_conv_shortcut: bool = True

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsampling_ratios))


CONFIG_24K = EncodecEncoderConfig()
CONFIG_48K = EncodecEncoderConfig(
    audio_channels=2, use_causal_conv=False, norm_type="time_group_norm"
)


def encoder_plan(cfg: EncodecEncoderConfig) -> list[tuple]:
    """[(kind, hf_index, meta)] — kinds: conv / resnet / elu / lstm. Mirrors
    HF EncodecEncoder.layers ModuleList indices."""
    plan: list[tuple] = []
    i = 0

    def emit(kind, meta=None):
        nonlocal i
        plan.append((kind, i, meta or {}))
        i += 1

    emit("conv", dict(k=cfg.kernel_size, stride=1, dil=1))
    scaling = 1
    for ratio in reversed(cfg.upsampling_ratios):
        for j in range(cfg.num_residual_layers):
            emit("resnet", dict(dilations=(cfg.dilation_growth_rate**j, 1)))
        emit("elu")
        emit("conv", dict(k=ratio * 2, stride=ratio, dil=1))
        scaling *= 2
    emit("lstm")
    emit("elu")
    emit("conv", dict(k=cfg.last_kernel_size, stride=1, dil=1))
    return plan


# --------------------------------------------------------------------------- #
# Modules (parameters only; the forward is the functions below)
# --------------------------------------------------------------------------- #


class Conv(nn.Module):
    """One conv's parameters: ``weight`` (C_out, C_in, K), ``bias``, and the
    time group norm's ``norm_scale``/``norm_bias`` when the config has it."""

    def __init__(self, cin: int, cout: int, k: int, norm: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        if norm:
            self.norm_scale = nn.Parameter(torch.ones(cout))
            self.norm_bias = nn.Parameter(torch.zeros(cout))


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, k: int, shortcut: bool, norm: bool):
        super().__init__()
        self.block_conv1 = Conv(dim, hidden, k, norm)
        self.block_conv2 = Conv(hidden, dim, 1, norm)
        if shortcut:
            self.shortcut = Conv(dim, dim, 1, norm)


class Lstm(nn.Module):
    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=num_layers)


class EncodecEncoder(nn.Module):
    """Parameter tree of the SEANet encoder, keyed by HF layer index; the
    forward is ``encodec_encode``."""

    def __init__(self, cfg: EncodecEncoderConfig):
        super().__init__()
        self.cfg = cfg
        norm = cfg.norm_type == "time_group_norm"
        self.layers = nn.ModuleDict()
        scaling = 1
        for kind, idx, meta in encoder_plan(cfg):
            cur = scaling * cfg.num_filters
            if kind == "conv":
                if idx == 0:
                    self.layers[str(idx)] = Conv(
                        cfg.audio_channels, cfg.num_filters, meta["k"], norm
                    )
                elif meta["stride"] > 1:
                    self.layers[str(idx)] = Conv(cur, cur * 2, meta["k"], norm)
                    scaling *= 2
                else:  # final projection
                    self.layers[str(idx)] = Conv(cur, cfg.hidden_size, meta["k"], norm)
            elif kind == "resnet":
                self.layers[str(idx)] = ResnetBlock(
                    cur, cur // cfg.compress, cfg.residual_kernel_size, cfg.use_conv_shortcut, norm
                )
            elif kind == "lstm":
                self.layers[str(idx)] = Lstm(cur, cfg.num_lstm_layers)


# --------------------------------------------------------------------------- #
# Building blocks (NCT layout, x: (B, C, T))
# --------------------------------------------------------------------------- #


def _pad1d(x: torch.Tensor, pad_left: int, pad_right: int, mode: str) -> torch.Tensor:
    """HF EncodecConv1d._pad1d, incl. the reflect small-input guard."""
    if mode != "reflect":
        return F.pad(x, (pad_left, pad_right))
    length = x.shape[-1]
    max_pad = max(pad_left, pad_right)
    extra = 0
    if length <= max_pad:
        extra = max_pad - length + 1
        x = F.pad(x, (0, extra))
    y = F.pad(x, (pad_left, pad_right), mode="reflect")
    if extra:
        y = y[..., : y.shape[-1] - extra]
    return y


def _conv_layer(cfg: EncodecEncoderConfig, p: Conv, x: torch.Tensor, k: int, stride: int,
                dil: int) -> torch.Tensor:
    k_eff = (k - 1) * dil + 1
    padding_total = k_eff - stride
    length = x.shape[-1]
    n_frames = (length - k_eff + padding_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - padding_total)
    extra = ideal - length

    if cfg.use_causal_conv:
        x = _pad1d(x, padding_total, extra, cfg.pad_mode)
    else:
        pad_r = padding_total // 2
        x = _pad1d(x, padding_total - pad_r, pad_r + extra, cfg.pad_mode)

    y = F.conv1d(x, p.weight, p.bias, stride=stride, dilation=dil)

    if cfg.norm_type == "time_group_norm":
        # GroupNorm(1, C): normalize over (C, T) jointly per sample. bf16
        # takes the moments in one pass with float32 sums (clamped at 0: on a
        # near-constant segment the cancellation can dip below -1e-5 and NaN
        # the rsqrt); float32 keeps the two-pass mean and variance, where the
        # one-pass form cancels catastrophically.
        if y.dtype == torch.bfloat16:
            y32 = y.float()
            mean = y32.mean(dim=(1, 2), keepdim=True)
            m2 = (y32 * y32).mean(dim=(1, 2), keepdim=True)
            var = (m2 - mean * mean).clamp_min(0.0)
            y = ((y32 - mean) * torch.rsqrt(var + 1e-5)).to(y.dtype)
        else:
            mean = y.mean(dim=(1, 2), keepdim=True)
            var = y.var(dim=(1, 2), keepdim=True, correction=0)
            y = (y - mean) * torch.rsqrt(var + 1e-5)
        y = y * p.norm_scale[None, :, None] + p.norm_bias[None, :, None]
    return y


def _resnet_block(cfg: EncodecEncoderConfig, p: ResnetBlock, x: torch.Tensor,
                  dilations: tuple[int, int]) -> torch.Tensor:
    # FADTK_TPU_FUSED_RESNET=1 runs the 24k-class block (causal, reflect,
    # k=3, dilation 1, k=1 shortcut, no in-conv norm) as one fused kernel;
    # the guard is the JAX package's. Off by default.
    from ..ops import fused_resnet as fr

    if (
        fr.fused_resnet_enabled()
        and cfg.use_causal_conv
        and cfg.pad_mode == "reflect"
        and cfg.norm_type == "weight_norm"
        and cfg.residual_kernel_size == 3
        and dilations[0] == 1
        and cfg.use_conv_shortcut
        and x.shape[-1] >= 3
    ):
        return fr.fused_resnet_causal(
            x,
            p.block_conv1.weight,
            p.block_conv1.bias,
            p.block_conv2.weight[:, :, 0],
            p.block_conv2.bias,
            p.shortcut.weight[:, :, 0],
            p.shortcut.bias,
        )

    r = x
    h = F.elu(x)
    h = _conv_layer(cfg, p.block_conv1, h, cfg.residual_kernel_size, 1, dilations[0])
    h = F.elu(h)
    h = _conv_layer(cfg, p.block_conv2, h, 1, 1, 1)
    if cfg.use_conv_shortcut:
        r = _conv_layer(cfg, p.shortcut, r, 1, 1, 1)
    return r + h


def _lstm(p: Lstm, x: torch.Tensor) -> torch.Tensor:
    """2-layer LSTM with skip (HF EncodecLSTM). x: (B, C, T)."""
    h0 = x.permute(2, 0, 1)  # (T, B, C)
    seq, _ = p.lstm(h0)
    return (seq + h0).permute(1, 2, 0)


def encodec_encode(model: EncodecEncoder, audio: torch.Tensor) -> torch.Tensor:
    """(B, channels, T) -> (B, T_frames, hidden_size) float32 latents.

    Compute follows the weight dtype (float32, or bf16 once the module is
    cast); the audio moves to the weights' device and dtype.
    """
    cfg = model.cfg
    w = model.layers["0"].weight
    x = audio.to(device=w.device, dtype=w.dtype)
    for kind, idx, meta in encoder_plan(cfg):
        if kind == "elu":
            x = F.elu(x)
            continue
        p = model.layers[str(idx)]
        if kind == "conv":
            x = _conv_layer(cfg, p, x, meta["k"], meta["stride"], meta["dil"])
        elif kind == "resnet":
            x = _resnet_block(cfg, p, x, meta["dilations"])
        elif kind == "lstm":
            x = _lstm(p, x)
    return x.transpose(1, 2).float()


# --------------------------------------------------------------------------- #
# Random init (tests / benchmarks)
# --------------------------------------------------------------------------- #


@torch.no_grad()
def init_encodec_params(model: EncodecEncoder, generator: torch.Generator) -> EncodecEncoder:
    """Random weights in the JAX package's scheme: conv kernels
    U(±1/√(k·C_in)), LSTM matrices U(±1/√dim), biases 0 (the conv biases and
    norm parameters keep their constructor values, 0 and 1). A
    torch.Generator gives other numbers than a jax key from the same seed."""

    def uniform(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * s) - s)

    for m in model.modules():
        if isinstance(m, Conv):
            cout, cin, k = m.weight.shape
            uniform(m.weight, 1.0 / math.sqrt(k * cin))
        elif isinstance(m, nn.LSTM):
            for name, param in m.named_parameters():
                if name.startswith("weight"):
                    uniform(param, 1.0 / math.sqrt(m.hidden_size))
                else:
                    param.zero_()
    return model
