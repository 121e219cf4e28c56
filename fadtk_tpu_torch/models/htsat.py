"""HTSAT (hierarchical token-semantic audio transformer, Swin-style) in PyTorch.

Port of ``fadtk_tpu/models/htsat.py``: the audio tower of both CLAP variants
the reference registers, LAION-CLAP's HTSAT-tiny/base (reference
fadtk/model_loader.py:385) and MS-CLAP 2023's HTSAT (:484,510), with HF
transformers' ClapAudioModel semantics.

Pipeline (eval mode):
  (B, 1, T, mel) log-mel -> per-mel-bin batch norm -> bicubic time
  interpolation to spec_size * freq_ratio (align_corners, a precomputed
  matrix) -> 4-crop time->freq stacking into a (256, 256) image -> 4x4 patch
  embed + LN -> 4 Swin stages (window attention with the relative-position
  bias, shifted windows under the static mask, patch merging) -> LN ->
  freq/time regroup -> average pool = pooled embedding.

The module tree mirrors the JAX parameter tree (``init_htsat_params`` and the
converted ``.npz``), so ``weights/store.py::params_from_jax`` maps it one to
one: dense kernels transposed, the patch-embed conv HWIO -> OIHW, norm
``scale`` -> ``weight``; the batch norm's ``mean``/``var`` statistics and the
relative-position tables keep their names. Compute follows the weights'
dtype; LayerNorm statistics and the attention softmax stay float32. Window
attention is plain torch (the JAX package computes it with einsums, not a
Pallas kernel), one window per product: the JAX package's window merging for
the TPU's matrix unit (``FADTK_TPU_SWIN_MERGE``) and its bf16 one-pass
LayerNorm are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import gelu


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    num_mel_bins: int = 64
    window_size: int = 8
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    embed_dim: int = 96  # patch_embeds_hidden_size; tiny=96, base=128
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.num_mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @property
    def grid_size(self) -> int:
        return self.spec_size // self.patch_stride


HTSAT_TINY = HTSATConfig(embed_dim=96)
HTSAT_BASE = HTSATConfig(embed_dim=128)


# --------------------------------------------------------------------------- #
# Host-precomputed constants (numpy, float64 then cast once)
# --------------------------------------------------------------------------- #


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's bicubic uses a=-0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1.0,
        (a + 2) * t**3 - (a + 3) * t**2 + 1,
        np.where(t < 2.0, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
    )


@lru_cache(maxsize=16)
def bicubic_interp_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) float32 matrix == ``F.interpolate(..., mode='bicubic',
    align_corners=True)`` along one axis, with index clamping at the borders."""
    m = np.zeros((out_len, in_len))
    scale = (in_len - 1) / (out_len - 1) if out_len > 1 else 0.0
    for i in range(out_len):
        x = i * scale
        x0 = math.floor(x)
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), in_len - 1)
            m[i, idx] += _cubic_kernel(np.asarray(x - (x0 + k)))
    return m.astype(np.float32)


@lru_cache(maxsize=32)
def relative_position_index(window: int) -> np.ndarray:
    """(W*W, W*W) index into the (2W-1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@lru_cache(maxsize=64)
def shift_attn_mask(height: int, width: int, window: int, shift: int) -> np.ndarray | None:
    """Static shifted-window attention mask (HF ClapAudioLayer.get_attn_mask),
    (nW, W*W, W*W) float32: -100 between tokens from different source
    regions, 0 elsewhere; None without a shift."""
    if shift == 0:
        return None
    img = np.zeros((height, width))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    img = img.reshape(height // window, window, width // window, window)
    windows = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _device_constant(name: str, device: torch.device, *args) -> torch.Tensor | None:
    """One of the constants above as a tensor on ``device``, made once."""
    fn = {"interp": bicubic_interp_matrix, "rel_index": relative_position_index,
          "shift_mask": shift_attn_mask}[name]
    a = fn(*args)
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)


# --------------------------------------------------------------------------- #
# Modules (names mirror the JAX parameter tree)
# --------------------------------------------------------------------------- #


class BatchNormStats(nn.Module):
    """Eval-mode per-mel-bin batch norm: ``weight``/``bias`` and the running
    ``mean``/``var`` (the JAX tree's names)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_stride,
                              padding=(cfg.patch_size - cfg.patch_stride) // 2)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.output = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * window - 1) ** 2, heads)))


class SwinBlock(nn.Module):
    def __init__(self, cfg: HTSATConfig, dim: int, heads: int):
        super().__init__()
        hidden = int(dim * cfg.mlp_ratio)
        self.layernorm_before = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attention = WindowAttention(dim, heads, cfg.window_size)
        self.layernorm_after = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(dim, hidden)
        self.mlp_output = nn.Linear(hidden, dim)


class PatchMerging(nn.Module):
    def __init__(self, cfg: HTSATConfig, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=cfg.layer_norm_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class Stage(nn.Module):
    def __init__(self, cfg: HTSATConfig, i: int, dim: int):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(cfg, dim, cfg.num_heads[i])
                                    for _ in range(cfg.depths[i]))
        if i < len(cfg.depths) - 1:
            self.downsample = PatchMerging(cfg, dim)


class HTSAT(nn.Module):
    """The HTSAT tower; ``head`` adds a projection: "laion" (``audio_projection``,
    linear -> relu -> linear, 512), "msclap" (``projection``, bias-free linears
    with GELU, residual and LayerNorm, 1024) or None."""

    def __init__(self, cfg: HTSATConfig, head: str | None = None, projection_dim: int = 512):
        super().__init__()
        self.cfg = cfg
        self.batch_norm = BatchNormStats(cfg.num_mel_bins)
        self.patch_embed = PatchEmbed(cfg)
        dims = [cfg.embed_dim * 2**i for i in range(len(cfg.depths))]
        self.stages = nn.ModuleList(Stage(cfg, i, dims[i]) for i in range(len(cfg.depths)))
        self.norm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps)
        d = cfg.num_features
        if head == "laion":
            self.audio_projection = nn.Module()
            self.audio_projection.linear1 = nn.Linear(d, projection_dim)
            self.audio_projection.linear2 = nn.Linear(projection_dim, projection_dim)
        elif head == "msclap":
            self.projection = nn.Module()
            self.projection.linear1 = nn.Linear(d, projection_dim, bias=False)
            self.projection.linear2 = nn.Linear(projection_dim, projection_dim, bias=False)
            self.projection.layer_norm = nn.LayerNorm(projection_dim)
        elif head is not None:
            raise ValueError(f"unknown HTSAT head {head!r}")


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    # Statistics in float32 regardless of compute dtype (bf16 fast mode).
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _window_attention(p: WindowAttention, x: torch.Tensor, heads: int, window: int,
                      attn_mask: torch.Tensor | None) -> torch.Tensor:
    """x: (B * nW, W*W, C) windows -> the same shape. Logits in the compute
    dtype plus the relative-position bias and the shift mask; softmax in
    float32."""
    nb, ww, c = x.shape
    hd = c // heads

    def split(t):
        return t.reshape(nb, ww, heads, hd).transpose(1, 2)

    q, k, v = split(p.query(x)), split(p.key(x)), split(p.value(x))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    rel = _device_constant("rel_index", x.device, window).reshape(-1)
    bias = p.relative_position_bias_table[rel].reshape(ww, ww, heads).permute(2, 0, 1)
    logits = logits.float() + bias.float()[None]
    if attn_mask is not None:
        nw = attn_mask.shape[0]
        logits = (logits.reshape(nb // nw, nw, heads, ww, ww) + attn_mask[None, :, None])
        logits = logits.reshape(nb, heads, ww, ww)
    w = torch.softmax(logits, dim=-1).to(x.dtype)
    out = (w @ v).transpose(1, 2).reshape(nb, ww, c)
    return p.output(out)


def _swin_block(cfg: HTSATConfig, p: SwinBlock, x: torch.Tensor, dims: tuple[int, int],
                heads: int, shift: int) -> torch.Tensor:
    """x: (B, H*W, C); pre-norm window attention + MLP (HF ClapAudioLayer)."""
    h, w = dims
    window = cfg.window_size
    if min(h, w) <= window:
        shift, window = 0, min(h, w)
    b, _, c = x.shape
    shortcut = x
    y = _ln(x, p.layernorm_before).reshape(b, h, w, c)

    pad_r = (window - w % window) % window
    pad_b = (window - h % window) % window
    if pad_r or pad_b:
        y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))

    mask = _device_constant("shift_mask", x.device, hp, wp, window, shift)
    attn = _window_attention(p.attention, _window_partition(y, window), heads, window, mask)
    y = _window_reverse(attn.reshape(-1, window, window, c), window, hp, wp)

    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    if pad_r or pad_b:
        y = y[:, :h, :w]
    x = shortcut + y.reshape(b, h * w, c)
    z = p.mlp_output(gelu(p.intermediate(_ln(x, p.layernorm_after))))
    return x + z


def _patch_merging(p: PatchMerging, x: torch.Tensor, dims: tuple[int, int]) -> torch.Tensor:
    h, w = dims
    b, _, c = x.shape
    y = x.reshape(b, h, w, c)
    if h % 2 or w % 2:
        y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
    parts = [y[:, 0::2, 0::2], y[:, 1::2, 0::2], y[:, 0::2, 1::2], y[:, 1::2, 1::2]]
    y = torch.cat(parts, dim=-1).reshape(b, -1, 4 * c)
    return p.reduction(_ln(y, p.norm))


def htsat_forward(model: HTSAT, input_features: torch.Tensor) -> torch.Tensor:
    """(B, 1, T, mel) log-mel -> (B, num_features) pooled embedding, in the
    weights' dtype (HF ClapAudioEncoder.forward, pooler_output path). The
    features move to the weights' device and dtype."""
    cfg = model.cfg
    b, ch, t, mel = input_features.shape
    if ch != 1 or mel != cfg.num_mel_bins:
        raise ValueError(f"HTSAT expects (B, 1, T, {cfg.num_mel_bins}), got "
                         f"{tuple(input_features.shape)}")
    w = model.patch_embed.proj.weight
    bn = model.batch_norm
    x = input_features.to(device=w.device, dtype=w.dtype)
    x = (x - bn.mean) / torch.sqrt(bn.var + 1e-5) * bn.weight + bn.bias

    # reshape_mel2img: bicubic align-corners time interpolation to
    # spec_size * freq_ratio, then the 4-crop stacking into a square image.
    # The restack needs mel * freq_ratio == spec_size (every registered CLAP
    # configuration has it).
    fr = cfg.freq_ratio
    spec_width = cfg.spec_size * fr
    if t > spec_width or mel != cfg.spec_size // fr:
        raise ValueError(f"HTSAT: T={t} > {spec_width} or mel bins {mel} != "
                         f"spec_size/freq_ratio {cfg.spec_size // fr}")
    if t < spec_width:
        x = _device_constant("interp", x.device, t, spec_width).to(x.dtype) @ x
    x = x.reshape(b, fr, spec_width // fr, mel).transpose(2, 3).reshape(
        b, 1, mel * fr, spec_width // fr)

    pe = model.patch_embed
    y = pe.proj(x)  # (B, E, g, g)
    g = cfg.grid_size
    y = _ln(y.flatten(2).transpose(1, 2), pe.norm)  # (B, g*g, E)

    dims = (g, g)
    for i, stage in enumerate(model.stages):
        for j, block in enumerate(stage.blocks):
            shift = 0 if j % 2 == 0 else cfg.window_size // 2
            y = _swin_block(cfg, block, y, dims, cfg.num_heads[i], shift)
        if hasattr(stage, "downsample"):
            y = _patch_merging(stage.downsample, y, dims)
            dims = ((dims[0] + 1) // 2, (dims[1] + 1) // 2)
    y = _ln(y, model.norm)

    # Frequency/time regroup + global average pool (HF ClapAudioEncoder tail).
    nchan = cfg.num_features
    down = 2 ** (len(cfg.depths) - 1)
    freq_shape = temporal_shape = mel * fr // down // cfg.patch_stride
    y = y.transpose(1, 2).reshape(b, nchan, freq_shape, temporal_shape)
    c_freq_bin = freq_shape // fr
    y = y.reshape(b, nchan, freq_shape // c_freq_bin, c_freq_bin, temporal_shape)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nchan, c_freq_bin, -1)
    return y.reshape(b, nchan, -1).mean(dim=-1)


def clap_audio_projection(model: HTSAT, x: torch.Tensor) -> torch.Tensor:
    """HF ClapProjectionLayer: linear -> relu -> linear."""
    p = model.audio_projection
    return p.linear2(torch.relu(p.linear1(x)))


def msclap_projection(model: HTSAT, x: torch.Tensor) -> torch.Tensor:
    """msclap Projection: layer_norm(p1 + linear2(gelu(p1))) with p1 =
    linear1(x); both linears bias-free (msclap/models/clap.py), the GELU the
    exact erf form in both precision modes, as the JAX package has it."""
    p = model.projection
    p1 = p.linear1(x)
    return _ln(p1 + p.linear2(F.gelu(p1)), p.layer_norm)


# --------------------------------------------------------------------------- #
# Random init (tests / benchmarks)
# --------------------------------------------------------------------------- #


@torch.no_grad()
def init_htsat_params(model: HTSAT, generator: torch.Generator) -> HTSAT:
    """Random weights in the JAX package's scheme: dense kernels
    U(±1/√fan_in) (the msclap projection's N(0, 0.02²)), biases 0,
    LayerNorm 1/0, relative-position tables and the patch-embed conv
    N(0, 0.02²), batch norm at mean 0 / var 1 / scale 1 / bias 0. Numbers are
    drawn on the generator's device; a torch.Generator gives other numbers
    than a jax key from the same seed."""
    dev = generator.device

    def uniform(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator, device=dev) * (2 * s) - s)

    def normal(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=dev) * s)

    msclap = getattr(model, "projection", None)
    msclap_linears = {id(m) for m in (msclap.linear1, msclap.linear2)} if msclap else set()
    for m in model.modules():
        if isinstance(m, nn.Linear):
            if id(m) in msclap_linears:
                normal(m.weight, 0.02)
            else:
                uniform(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            normal(m.relative_position_bias_table, 0.02)
        elif isinstance(m, BatchNormStats):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
    normal(model.patch_embed.proj.weight, 0.02)
    model.patch_embed.proj.bias.zero_()
    return model
