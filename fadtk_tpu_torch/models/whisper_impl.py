"""Whisper (encoder + decoder) in PyTorch.

Port of ``fadtk_tpu/models/whisper_impl.py``. Parity target: HF WhisperModel
as the reference invokes it (fadtk/model_loader.py:636-672) — a full seq2seq
forward with two forced decoder-start tokens, taking the decoder's
last_hidden_state, i.e. exactly 2 embedding frames per 30 s window.

Architecture (HF modeling_whisper):
- encoder: conv(80->d, k3, p1) GELU; conv(d->d, k3, s2, p1) GELU; + fixed
  sinusoidal positions (stored as weights); pre-norm transformer; final LN;
- attention: q/v/out projections have bias, k_proj has NO bias;
- decoder: learned positions from index 0; pre-norm; causal self-attention +
  cross-attention onto the encoder states; final LN.

The module tree mirrors the JAX parameter tree, so a converted ``.npz``
maps one to one (``weights/store.py::params_from_jax``: dense kernels
transposed, conv kernels from "HIO"). Compute follows the weights' dtype;
LayerNorm statistics stay float32. Attention is plain torch (matmul,
softmax) with logits in the compute dtype, as the JAX package does: it
measured that no fused kernel pays here (fadtk_tpu/models/whisper_impl.py,
``_attention``), so the flash kernel is not on this path.

Traced (``runner/profiling.py``) as the spans ``model.attention`` and
``model.ffn`` in every encoder and decoder layer, ``model.cross_attention``
in every decoder layer, ``model.decoder`` around the decoder, and the
counter ``model.windows`` (+B a forward). Each span opens around a function
that does the stage's whole work and opens no span of its own
(``_encoder_attention``, ``_feed_forward``, ``_decoder_attention``,
``_cross_attention``, ``_decoder_feed_forward``; the encoder's q·kᵀ,
softmax and p·v are ``_encoder_attention_core``), so that a profiler range
around one of them holds its kernels: a kernel belongs to the innermost
range it was launched in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..runner import profiling
from .base import linear, row_sharded_linear
from .precision import gelu


@dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    encoder_ffn: int = 1536
    decoder_ffn: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    decoder_start_token_id: int = 50257
    layer_norm_eps: float = 1e-5


_SIZES = {
    "tiny": WhisperConfig(),
    "base": WhisperConfig(d_model=512, encoder_layers=6, encoder_heads=8,
                          decoder_layers=6, decoder_heads=8,
                          encoder_ffn=2048, decoder_ffn=2048),
    "small": WhisperConfig(d_model=768, encoder_layers=12, encoder_heads=12,
                           decoder_layers=12, decoder_heads=12,
                           encoder_ffn=3072, decoder_ffn=3072),
    "medium": WhisperConfig(d_model=1024, encoder_layers=24, encoder_heads=16,
                            decoder_layers=24, decoder_heads=16,
                            encoder_ffn=4096, decoder_ffn=4096),
    "large": WhisperConfig(d_model=1280, encoder_layers=32, encoder_heads=20,
                           decoder_layers=32, decoder_heads=20,
                           encoder_ffn=5120, decoder_ffn=5120),
}


def config_for_size(size: str) -> WhisperConfig:
    return _SIZES[size]


# --------------------------------------------------------------------------- #
# Module tree (parameters only; the forward is the functions below)
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


def _layer(d: int, ffn: int, cross: bool) -> nn.ModuleDict:
    layer = nn.ModuleDict({
        "self_attn": Attention(d),
        "self_attn_layer_norm": nn.LayerNorm(d),
        "fc1": nn.Linear(d, ffn),
        "fc2": nn.Linear(ffn, d),
        "final_layer_norm": nn.LayerNorm(d),
    })
    if cross:
        layer["encoder_attn"] = Attention(d)
        layer["encoder_attn_layer_norm"] = nn.LayerNorm(d)
    return layer


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_source_positions, d))
        self.layers = nn.ModuleList(
            _layer(d, cfg.encoder_ffn, cross=False) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_target_positions, d))
        self.layers = nn.ModuleList(
            _layer(d, cfg.decoder_ffn, cross=True) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d)


class Whisper(nn.Module):
    """Parameter tree of WhisperModel (encoder, decoder); the forward is
    ``whisper_forward``."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #


def _ln(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    # Statistics in float32 regardless of compute dtype (bf16 fast mode).
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def _attention(p: Attention, x: torch.Tensor, kv: torch.Tensor, num_heads: int,
               causal: bool = False, tp_group=None, core=None) -> torch.Tensor:
    """Whisper attention, logits and softmax in the compute dtype; kv is x
    for self-attention. k_proj has no bias. ``num_heads`` is the model's;
    ``p`` holds all of them or a tensor-parallel shard's
    (``parallel/whisper_tp.py``), whose out_proj partial sums ``tp_group``
    adds up. ``core`` computes softmax(q kᵀ) v (default
    ``_attention_core``)."""
    b, tq, d = x.shape
    tk = kv.shape[1]
    hd = d // num_heads
    heads = p.q_proj.weight.shape[0] // hd

    def split(t, tlen):
        return t.reshape(b, tlen, heads, hd).transpose(1, 2)

    q = split(linear(p.q_proj, x), tq) * (hd ** -0.5)
    k = split(linear(p.k_proj, kv), tk)
    v = split(linear(p.v_proj, kv), tk)
    out = (core or _attention_core)(q, k, v, causal)
    out = out.transpose(1, 2).reshape(b, tq, heads * hd)
    return row_sharded_linear(p.out_proj, out, tp_group)


def _attention_core(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ) v over (B, H, T, hd) heads, q already scaled; a causal
    mask lets query t see keys up to t."""
    logits = q @ k.transpose(-1, -2)
    if causal:
        tq, tk = logits.shape[-2:]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=-1) @ v


def _encoder_attention_core(q, k, v, causal: bool = False) -> torch.Tensor:
    """The encoder's ``_attention_core``, under a name of its own: a range
    around it holds the encoder's q·kᵀ, softmax and p·v, none of the
    decoder's."""
    return _attention_core(q, k, v, causal)


def _encoder_attention(cfg: WhisperConfig, p: nn.ModuleDict, x, tp_group=None):
    """x + self-attention(LN(x)) in an encoder layer."""
    h = _ln(x, p["self_attn_layer_norm"], cfg.layer_norm_eps)
    return x + _attention(p["self_attn"], h, h, cfg.encoder_heads, tp_group=tp_group,
                          core=_encoder_attention_core)


def _feed_forward(cfg: WhisperConfig, p: nn.ModuleDict, x, tp_group=None):
    """x + fc2(GELU(fc1(LN(x)))): an encoder layer's feed-forward."""
    h = _ln(x, p["final_layer_norm"], cfg.layer_norm_eps)
    return x + row_sharded_linear(p["fc2"], gelu(linear(p["fc1"], h)), tp_group)


def _decoder_attention(cfg: WhisperConfig, p: nn.ModuleDict, x, tp_group=None):
    """x + causal self-attention(LN(x)) in a decoder layer."""
    h = _ln(x, p["self_attn_layer_norm"], cfg.layer_norm_eps)
    return x + _attention(p["self_attn"], h, h, cfg.decoder_heads, causal=True,
                          tp_group=tp_group)


def _cross_attention(cfg: WhisperConfig, p: nn.ModuleDict, x, enc_states, tp_group=None):
    """x + attention(LN(x)) onto the encoder states in a decoder layer: its
    k and v project all of them."""
    h = _ln(x, p["encoder_attn_layer_norm"], cfg.layer_norm_eps)
    return x + _attention(p["encoder_attn"], h, enc_states, cfg.decoder_heads,
                          tp_group=tp_group)


def _decoder_feed_forward(cfg: WhisperConfig, p: nn.ModuleDict, x, tp_group=None):
    """A decoder layer's ``_feed_forward``, under a name of its own so that
    a range around it holds none of the encoder's kernels."""
    return _feed_forward(cfg, p, x, tp_group)


def whisper_encode(model: Whisper, input_features: torch.Tensor,
                   tp_group=None) -> torch.Tensor:
    """(B, 80, 3000) log-mel -> (B, 1500, d) encoder states. A model that
    holds one tp rank's shard sums its row-parallel projections over
    ``tp_group``."""
    cfg, enc = model.cfg, model.encoder
    x = gelu(enc.conv1(input_features))
    x = gelu(enc.conv2(x)).transpose(1, 2)  # (B, 1500, d)
    x = x + enc.embed_positions[None, : x.shape[1]]
    for p in enc.layers:
        with profiling.stage("model.attention"):
            x = _encoder_attention(cfg, p, x, tp_group)
        with profiling.stage("model.ffn"):
            x = _feed_forward(cfg, p, x, tp_group)
    return _ln(x, enc.layer_norm, cfg.layer_norm_eps)


def whisper_decode(model: Whisper, token_ids: torch.Tensor, enc_states: torch.Tensor,
                   tp_group=None) -> torch.Tensor:
    """(B, T) tokens + encoder states -> (B, T, d) decoder last hidden state;
    ``tp_group`` as in ``whisper_encode``."""
    cfg, dec = model.cfg, model.decoder
    x = dec.embed_tokens[token_ids] + dec.embed_positions[None, : token_ids.shape[1]]
    for p in dec.layers:
        with profiling.stage("model.attention"):
            x = _decoder_attention(cfg, p, x, tp_group)
        with profiling.stage("model.cross_attention"):
            x = _cross_attention(cfg, p, x, enc_states, tp_group)
        with profiling.stage("model.ffn"):
            x = _decoder_feed_forward(cfg, p, x, tp_group)
    return _ln(x, dec.layer_norm, cfg.layer_norm_eps)


def whisper_forward(model: Whisper, input_features: torch.Tensor,
                    tp_group=None) -> torch.Tensor:
    """The reference's embedding forward: 2 forced start tokens -> (B, 2, d)
    float32 decoder states (fadtk/model_loader.py:662,669). The features
    move to the weights' device and dtype (the frontend is float32 in both
    precision modes). ``tp_group`` as in ``whisper_encode``. Counts its B
    windows under ``model.windows``; the decoder is the span
    ``model.decoder``."""
    w = model.encoder.conv1.weight
    input_features = input_features.to(device=w.device, dtype=w.dtype)
    b = input_features.shape[0]
    profiling.count("model.windows", b)
    enc_states = whisper_encode(model, input_features, tp_group)
    tokens = torch.full((b, 2), model.cfg.decoder_start_token_id, dtype=torch.long,
                        device=w.device)
    with profiling.stage("model.decoder"):
        out = whisper_decode(model, tokens, enc_states, tp_group)
    return out.float()


# --------------------------------------------------------------------------- #
# Random init (tests / benchmarks)
# --------------------------------------------------------------------------- #


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions (stored as weights)."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


@torch.no_grad()
def init_whisper_params(model: Whisper, generator: torch.Generator) -> Whisper:
    """Random weights in the JAX package's scheme: dense and conv kernels
    U(±1/√fan_in), biases 0, LayerNorm 1/0, sinusoidal encoder positions,
    token and decoder-position embeddings N(0, 0.02²). Numbers are drawn on
    the generator's device (a CUDA generator fills a model on the card
    without a host copy); a torch.Generator gives other numbers than a jax
    key from the same seed."""
    dev = generator.device

    def uniform(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.rand(t.shape, generator=generator, device=dev) * (2 * s) - s)

    def normal(t: torch.Tensor, s: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=dev) * s)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            uniform(m.weight, 1.0 / math.sqrt(m.in_features))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            cout, cin, k = m.weight.shape
            uniform(m.weight, 1.0 / math.sqrt(k * cin))
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    enc, dec = model.encoder, model.decoder
    enc.embed_positions.copy_(torch.from_numpy(_sinusoids(*enc.embed_positions.shape)))
    normal(dec.embed_tokens, 0.02)
    normal(dec.embed_positions, 0.02)
    return model
