"""Shared speech-transformer encoder (wav2vec 2.0 / HuBERT / WavLM / MERT).

The torch counterpart of ``fadtk_tpu/models/speech/encoder.py``, held against
it in tests/test_torch_speech_encoder.py. Same numerics contract:

- **Exact masking.** Clips are batched padded to length buckets; every
  cross-time operation (the conv extractor's group norm, the positional conv,
  attention) is mask-aware, so valid frames equal an unpadded run.
- **Compute dtype follows the parameters.** float32 parameters give the
  reference-parity path; bfloat16 parameters the throughput path, where norm
  statistics, attention logits and softmax stay float32 (models/precision.py)
  and attention runs the hand-written flash kernel (WavLM's with its
  factorized gated bias).
- **Module tree = parameter tree.** ``nn.ModuleDict``/``nn.ModuleList`` and
  ``Attention`` attribute names mirror the JAX pytree, so
  ``weights.store.params_from_jax`` maps a converted ``.npz`` onto
  ``state_dict`` keys one to one.

Layouts: public functions take and return JAX's (B, T, C); the convolutions
run in torch's (B, C, T) inside.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention_softmax import attention_softmax, dense_gated_bias
from ...runner import profiling
from ..base import linear, row_sharded_linear
from ..precision import gelu
from .config import SpeechEncoderConfig


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    # Statistics in float32 regardless of compute dtype (bf16 fast mode).
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# Module tree
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """Parameters of one attention block: the four projections and, for
    WavLM, the gate projection ``gru_rel_pos_linear`` (head_dim -> 8), the
    per-head ``gru_rel_pos_const`` and, on layer 0 only, the relative-position
    table ``rel_attn_embed`` (num_buckets, H). A module of its own because an
    ``nn.ModuleDict`` cannot hold the bare parameters."""

    def __init__(self, cfg: SpeechEncoderConfig, first_layer: bool):
        super().__init__()
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)
        if cfg.attention_type == "wavlm":
            self.gru_rel_pos_linear = nn.Linear(cfg.head_dim, 8)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(cfg.num_heads))
            if first_layer:
                self.rel_attn_embed = nn.Parameter(torch.zeros(cfg.num_buckets, cfg.num_heads))
        elif cfg.attention_type != "standard":
            raise ValueError(f"unknown attention_type {cfg.attention_type!r}")


class SpeechEncoder(nn.Module):
    """Parameters of the encoder; ``forward`` is ``speech_encoder_forward``."""

    def __init__(self, cfg: SpeechEncoderConfig):
        super().__init__()
        self.cfg = cfg
        conv_layers = []
        in_ch = 1
        for i, out_ch in enumerate(cfg.conv_dim):
            layer = nn.ModuleDict({
                "conv": nn.Conv1d(
                    in_ch, out_ch, cfg.conv_kernel[i], stride=cfg.conv_stride[i],
                    bias=cfg.conv_bias,
                )
            })
            if (cfg.feat_extract_norm == "group" and i == 0) or cfg.feat_extract_norm == "layer":
                layer["layer_norm"] = nn.LayerNorm(out_ch)
            conv_layers.append(layer)
            in_ch = out_ch
        self.feature_extractor = nn.ModuleDict({"conv_layers": nn.ModuleList(conv_layers)})

        h = cfg.hidden_size
        self.feature_projection = nn.ModuleDict({"projection": nn.Linear(cfg.conv_dim[-1], h)})
        if cfg.feat_proj_layer_norm:
            self.feature_projection["layer_norm"] = nn.LayerNorm(cfg.conv_dim[-1])

        def layer(i):
            return nn.ModuleDict({
                "attention": Attention(cfg, first_layer=i == 0),
                "layer_norm": nn.LayerNorm(h),
                "feed_forward": nn.ModuleDict({
                    "intermediate_dense": nn.Linear(h, cfg.intermediate_size),
                    "output_dense": nn.Linear(cfg.intermediate_size, h),
                }),
                "final_layer_norm": nn.LayerNorm(h),
            })

        self.encoder = nn.ModuleDict({
            "pos_conv": nn.Conv1d(
                h, h, cfg.num_conv_pos_embeddings,
                padding=cfg.num_conv_pos_embeddings // 2,
                groups=cfg.num_conv_pos_embedding_groups,
            ),
            "layer_norm": nn.LayerNorm(h),
            "layers": nn.ModuleList([layer(i) for i in range(cfg.num_layers)]),
        })

    def forward(self, audio, num_valid=None, taps=None):
        return speech_encoder_forward(self, audio, num_valid, taps)


@torch.no_grad()
def init_speech_encoder(model: SpeechEncoder, generator: torch.Generator) -> SpeechEncoder:
    """Random weights drawn from ``generator``, with the JAX package's init
    scheme (``init_speech_encoder_params``): dense kernels U(±1/√in), zero
    biases, conv-extractor kernels N(0, 1)·0.5/√(k·in), positional kernel
    N(0, 1)·0.02, norms at identity; WavLM's gate constants at one and its
    relative-position table N(0, 1)·0.02. The two frameworks draw different numbers;
    parity tests carry the JAX weights across through the ``.npz`` instead."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            s = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-s, s, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for layer in model.feature_extractor["conv_layers"]:
        conv = layer["conv"]
        fan = conv.kernel_size[0] * conv.in_channels
        conv.weight.normal_(generator=generator).mul_(0.5 / math.sqrt(fan))
        if conv.bias is not None:
            conv.bias.zero_()
    pos = model.encoder["pos_conv"]
    pos.weight.normal_(generator=generator).mul_(0.02)
    pos.bias.zero_()
    for layer in model.encoder["layers"]:
        attn = layer["attention"]
        if hasattr(attn, "gru_rel_pos_const"):
            attn.gru_rel_pos_const.fill_(1.0)
        if hasattr(attn, "rel_attn_embed"):
            attn.rel_attn_embed.normal_(generator=generator).mul_(0.02)
    return model


# --------------------------------------------------------------------------- #
# Conv feature extractor
# --------------------------------------------------------------------------- #


def _masked_group_norm_per_channel(x, mask, ln: nn.LayerNorm, eps=1e-5):
    """GroupNorm with num_groups == num_channels (per-channel instance norm over
    time, HF Wav2Vec2GroupNormConvLayer), statistics over valid frames only.

    x: (B, C, T); mask: (B, 1, T) in {0, 1}. float32 takes the two-pass centred
    moments; bfloat16 one pass with float32 sums, the variance clamped at 0
    (one-pass cancellation can dip below -eps on near-constant channels).
    """
    n = mask.sum(dim=2, keepdim=True).clamp(min=1.0)
    scale = ln.weight.float()[None, :, None]
    bias = ln.bias.float()[None, :, None]
    if x.dtype == torch.bfloat16:
        x32 = x.float()
        m = mask.float()
        s1 = (x32 * m).sum(dim=2, keepdim=True)
        s2 = (x32.square() * m).sum(dim=2, keepdim=True)
        mean = s1 / n.float()
        var = (s2 / n.float() - mean * mean).clamp(min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + eps)
        return (y * scale + bias).to(x.dtype)
    mean = (x * mask).sum(dim=2, keepdim=True) / n
    var = ((x - mean).square() * mask).sum(dim=2, keepdim=True) / n
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale + bias


def _feature_extractor(cfg: SpeechEncoderConfig, fe: nn.ModuleDict, audio, num_valid):
    """(B, T) audio, (B,) valid lengths -> (B, C, T_frames), (B, T_frames) mask,
    (B,) int32 valid frame counts."""
    x = audio[:, None, :]
    valid = num_valid.to(torch.int64)
    for i, layer in enumerate(fe["conv_layers"]):
        k, s = cfg.conv_kernel[i], cfg.conv_stride[i]
        x = layer["conv"](x)
        valid = torch.div(valid - k, s, rounding_mode="floor") + 1
        t = x.shape[2]
        mask = (torch.arange(t, device=x.device)[None, :] < valid[:, None]).to(x.dtype)
        if cfg.feat_extract_norm == "group" and i == 0:
            x = _masked_group_norm_per_channel(x, mask[:, None, :], layer["layer_norm"])
        elif cfg.feat_extract_norm == "layer":
            x = _layer_norm(x.transpose(1, 2), layer["layer_norm"], cfg.layer_norm_eps)
            x = x.transpose(1, 2)
        x = gelu(x)
    return x, mask, valid.to(torch.int32)


# --------------------------------------------------------------------------- #
# Positional conv embedding
# --------------------------------------------------------------------------- #


def pos_conv_embedding(cfg: SpeechEncoderConfig, conv: nn.Conv1d, x):
    """Grouped conv positional embedding with SAME-style padding and the
    even-kernel trailing-frame trim (HF Wav2Vec2PositionalConvEmbedding +
    SamePadLayer). x: (B, T, C) with padded frames already zeroed."""
    y = conv(x.transpose(1, 2))
    if cfg.num_conv_pos_embeddings % 2 == 0:
        y = y[:, :, :-1]
    return gelu(y).transpose(1, 2)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #


def _split_heads(x, num_heads):
    b, t, h = x.shape
    return x.reshape(b, t, num_heads, h // num_heads).transpose(1, 2)


def _attention_core(q, k, v, bias, gate=None, position_bias=None):
    """q, k, v: (B, H, T, D); bias: additive, broadcastable to (B, H, T, T),
    or, with WavLM's ``gate`` (B, T, H) and ``position_bias`` (H, T, T), the
    key mask (B, 1, 1, T) to which ``gate ⊙ position_bias`` adds
    (``ops.attention_softmax.dense_gated_bias``).

    Logits and softmax stay float32 (bf16 inputs multiply exactly in f32, so
    this is the bf16-in / f32-accumulate product of the JAX path). The bias
    and the softmax are ``ops.attention_softmax``: on a CUDA tensor one pass
    of the hand-written kernel over the logits, in place, launched here with
    no program range of its own, so that a profiler range around this
    function holds it; on the CPU, its twin's torch composition.
    """
    scale = q.shape[-1] ** -0.5
    logits = (q * scale).float() @ k.float().transpose(-1, -2)
    bias, gate, position_bias = (None if y is None else y.float()
                                 for y in (bias, gate, position_bias))
    w = attention_softmax(logits, bias, gate, position_bias)
    out = (w.to(v.dtype).float() @ v.float()).to(v.dtype)
    b, h, t, d = out.shape
    return out.transpose(1, 2).reshape(b, t, h * d)


# f32 attention takes the kernel only on opt-in, and only from this length
# (``FADTK_TPU_FLASH_F32_MIN_T`` overrides it).
_FLASH_F32_MIN_T = 640


def use_flash_attention(dtype, frame_valid, t: int | None, device: torch.device) -> bool:
    """Which attention serves this dtype/length (the JAX package's routing,
    ``fadtk_tpu/models/speech/encoder.py::use_flash_attention``):

    - bf16: always the flash kernel;
    - f32: the plain ``_attention_core`` (the parity path), unless
      ``FADTK_TPU_FLASH_F32=1`` and T >= ``FADTK_TPU_FLASH_F32_MIN_T``
      (stripped; 640 when unset or not all digits);
    - nothing when the kernel is disabled — by default on CPU tensors
      (``ops.flash_attention.flash_attention_enabled``).
    """
    from ...ops.flash_attention import flash_attention_enabled

    if frame_valid is None or not flash_attention_enabled(device):
        return False
    if dtype == torch.bfloat16:
        return True
    if dtype == torch.float32 and t is not None:
        if os.environ.get("FADTK_TPU_FLASH_F32", "").strip() == "1":
            raw = os.environ.get("FADTK_TPU_FLASH_F32_MIN_T", "").strip()
            return t >= (int(raw) if raw.isdigit() else _FLASH_F32_MIN_T)
    return False


def standard_attention(cfg: SpeechEncoderConfig, p: Attention, x, key_bias, frame_valid=None,
                       *, tp_group=None):
    """Multi-head attention (HF Wav2Vec2Attention) on the heads that ``p``
    holds: all of them, or a tensor-parallel shard's (``parallel/tp.py``),
    whose out_proj partial sums ``tp_group`` adds up."""
    heads = p.q_proj.weight.shape[0] // cfg.head_dim
    q, k, v = (linear(lin, x) for lin in (p.q_proj, p.k_proj, p.v_proj))
    if use_flash_attention(x.dtype, frame_valid, x.shape[1], x.device):
        # Packed-heads kernel: consumes the projection layout directly, no
        # (B, H, T, D) transposes.
        from ...ops.flash_attention import flash_attention_packed

        out = flash_attention_packed(q, k, v, frame_valid, num_heads=heads)
    else:
        qh, kh, vh = (_split_heads(y, heads) for y in (q, k, v))
        out = _attention_core(qh, kh, vh, key_bias)
    return row_sharded_linear(p.out_proj, out, tp_group)


def _wavlm_relative_buckets(num_buckets: int, max_distance: int, t: int) -> np.ndarray:
    """T5-style log-spaced relative position buckets (HF WavLMAttention
    ._relative_positions_bucket), (T, T) int64; static per sequence length.
    Computed in numpy float64 exactly as the JAX package does, so the two
    agree bit for bit (HF computes them in float32 and is not the
    reference here)."""
    half = num_buckets // 2
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]  # memory - context
    buckets = (rel > 0).astype(np.int64) * half
    rel = np.abs(rel)
    max_exact = half // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (half - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, half - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


@lru_cache(maxsize=16)
def _bucket_index(num_buckets: int, max_distance: int, t: int, device: torch.device):
    """The bucket table as an index tensor on ``device``, kept: a pageable
    host-to-device copy in every forward would block the host until the
    work queued before it (the conv frontend) has run, and leave the card
    idle while the layers are then launched."""
    buckets = _wavlm_relative_buckets(num_buckets, max_distance, t)
    return torch.from_numpy(buckets).to(device)


def wavlm_position_bias(cfg: SpeechEncoderConfig, rel_attn_embed: torch.Tensor, t: int):
    """(H, T, T) un-gated relative position bias from the layer-0 table, in
    the table's dtype, contiguous."""
    buckets = _bucket_index(cfg.num_buckets, cfg.max_bucket_distance, t, rel_attn_embed.device)
    bias = rel_attn_embed[buckets].permute(2, 0, 1).contiguous()  # (T, T, H) -> (H, T, T)
    profiling.count("model.position_bias_bytes", bias.numel() * bias.element_size())
    return bias


def wavlm_gated_bias(cfg: SpeechEncoderConfig, p: Attention, x, position_bias, key_bias, *,
                     first_head: int = 0, dense: bool = True):
    """WavLM's per-query, per-head gate on the relative position bias (HF
    WavLMAttention), for the heads that ``p`` holds from ``first_head`` on
    (all of them, or a tensor-parallel shard's).

    The gate is computed in the compute dtype from the *unprojected* per-head
    hidden states of ``x`` (B, T, H_all * head_dim): proj -> (..., 2, 4).sum(-1)
    -> sigmoid -> a * (b * const - 1) + 2. Returns it as (B, T, Hl), the
    layout the kernels read, and with ``dense`` the additive attention bias
    ``key_bias + gate ⊙ position_bias``, (B, Hl, T, T), of the plain path on
    the CPU; without, None (the flash kernels, and the plain path's softmax
    kernel on the card, add gate ⊙ bias in registers and build no dense
    term). Traced as the span ``model.gated_bias`` and the counter
    ``model.gated_bias_bytes`` (the dense bias's bytes, from its shape).
    """
    with profiling.stage("model.gated_bias"):
        gate, bias = _wavlm_gate_and_bias(cfg, p, x, position_bias, key_bias, first_head, dense)
    if bias is not None:
        profiling.count("model.gated_bias_bytes", bias.numel() * bias.element_size())
    return gate, bias


def _wavlm_gate_and_bias(cfg, p: Attention, x, position_bias, key_bias, first_head: int,
                         dense: bool):
    """The work of ``wavlm_gated_bias``, launched outside any range of the
    program's own, so that a profiler range around this function holds its
    kernels (a kernel belongs to the innermost range it was launched in)."""
    b, t, _ = x.shape
    heads = p.gru_rel_pos_const.shape[0]
    hs = x.reshape(b, t, -1, cfg.head_dim)[:, :, first_head:first_head + heads]
    proj = linear(p.gru_rel_pos_linear, hs).reshape(b, t, heads, 2, 4).sum(-1)
    gates = torch.sigmoid(proj)
    const = p.gru_rel_pos_const.reshape(1, 1, heads)
    gate = gates[..., 0] * (gates[..., 1] * const - 1.0) + 2.0  # (B, T, Hl)
    if not dense:
        return gate, None
    return gate, dense_gated_bias(key_bias, gate, position_bias)


def wavlm_attention(cfg: SpeechEncoderConfig, p: Attention, x, key_bias, position_bias,
                    frame_valid=None, *, tp_group=None, first_head: int = 0,
                    head_major: bool = False):
    """WavLM gated relative position bias attention (HF WavLMAttention), the
    gate and bias from ``wavlm_gated_bias``, on the heads that ``p`` holds
    from ``first_head`` on: all of them, or a tensor-parallel shard's
    (``parallel/tp.py``), whose out_proj partial sums ``tp_group`` adds up.
    ``position_bias`` holds the same heads.

    bf16 takes a flash kernel, which adds gate ⊙ position_bias per tile
    without building the dense (B, H, T, T) term; gate and bias are cast to
    float32 for it. The kernel is K1b (``flash_attention_packed``) on the
    projection layout, or with ``head_major`` K2 (``flash_attention``) on
    the head-split views, as the JAX package's tp step routes it. float32
    always takes the plain path ``_attention_core``, whatever
    ``FADTK_TPU_FLASH_F32`` says, as the JAX package does (its routing call
    passes no length). On the card that path adds the factorized gate and
    table inside its softmax kernel; on the CPU it takes the dense bias.
    """
    heads = p.q_proj.weight.shape[0] // cfg.head_dim
    q, k, v = (linear(lin, x) for lin in (p.q_proj, p.k_proj, p.v_proj))
    flash = use_flash_attention(x.dtype, frame_valid, None, x.device)  # no length: bf16 only
    gate, bias = wavlm_gated_bias(cfg, p, x, position_bias, key_bias, first_head=first_head,
                                  dense=not (flash or x.is_cuda))
    if flash and head_major:
        from ...ops.flash_attention import flash_attention

        o = flash_attention(*(_split_heads(y, heads) for y in (q, k, v)), frame_valid,
                            position_bias=position_bias.float(),
                            gate=gate.transpose(1, 2).float())
        out = o.transpose(1, 2).flatten(2)
    elif flash:
        from ...ops.flash_attention import flash_attention_packed

        out = flash_attention_packed(
            q, k, v, frame_valid, position_bias.float(), gate.float().contiguous(),
            num_heads=heads,
        )
    else:
        qkv = (_split_heads(y, heads) for y in (q, k, v))
        if bias is None:
            out = _attention_core(*qkv, key_bias, gate, position_bias)
        else:
            out = _attention_core(*qkv, bias)
    return row_sharded_linear(p.out_proj, out, tp_group)


# --------------------------------------------------------------------------- #
# Encoder layers
# --------------------------------------------------------------------------- #


def _feed_forward(p: nn.ModuleDict, x, tp_group=None):
    return row_sharded_linear(p["output_dense"], gelu(linear(p["intermediate_dense"], x)),
                              tp_group)


def encoder_layer(cfg: SpeechEncoderConfig, p: nn.ModuleDict, x, key_bias, position_bias,
                  frame_valid=None, *, tp_group=None, first_head: int = 0,
                  head_major: bool = False):
    """One transformer layer. The keywords serve a tensor-parallel shard
    (``parallel/tp.py``): ``tp_group`` sums the row-parallel projections,
    and ``first_head`` / ``head_major`` reach ``wavlm_attention``. Traced
    as the spans ``model.attention`` and ``model.ffn``."""
    eps = cfg.layer_norm_eps

    def attn(y):
        with profiling.stage("model.attention"):
            if cfg.attention_type == "wavlm":
                return wavlm_attention(cfg, p["attention"], y, key_bias, position_bias,
                                       frame_valid, tp_group=tp_group, first_head=first_head,
                                       head_major=head_major)
            return standard_attention(cfg, p["attention"], y, key_bias, frame_valid,
                                      tp_group=tp_group)

    def ffn(y):
        with profiling.stage("model.ffn"):
            return _feed_forward(p["feed_forward"], y, tp_group)

    if cfg.do_stable_layer_norm:
        # Pre-norm (HF Wav2Vec2EncoderLayerStableLayerNorm).
        x = x + attn(_layer_norm(x, p["layer_norm"], eps))
        x = x + ffn(_layer_norm(x, p["final_layer_norm"], eps))
    else:
        # Post-norm (HF Wav2Vec2EncoderLayer).
        x = _layer_norm(x + attn(x), p["layer_norm"], eps)
        x = _layer_norm(x + ffn(x), p["final_layer_norm"], eps)
    return x


# --------------------------------------------------------------------------- #
# Full forward
# --------------------------------------------------------------------------- #


def speech_encoder_forward(
    model: SpeechEncoder,
    audio: torch.Tensor,
    num_valid: torch.Tensor | None = None,
    taps: tuple[int, ...] | None = None,
    **shard,
):
    """Full forward pass.

    Args:
        audio: (B, T_samples) float32, zero-padded to a bucket length, on the
            model's device.
        num_valid: (B,) int true sample counts (defaults to full length).
        taps: hidden-state indices to return (None = all num_layers + 1).
        shard: ``encoder_layer``'s tensor-parallel keywords, for a model that
            holds one tp rank's shard (``parallel/tp.py``).

    Returns:
        hidden_states: (len(taps) or num_layers + 1, B, T_frames, H), in the
            parameter dtype — HF's output_hidden_states tuple, stacked (one
            tap comes as a view, without a copy).
        frame_mask: (B, T_frames) validity mask.
    """
    cfg = model.cfg
    if num_valid is None:
        num_valid = torch.full(audio.shape[:1], audio.shape[1], dtype=torch.int32,
                               device=audio.device)
    with profiling.stage("model.extractor"):
        x, frame_mask, frame_valid, key_bias, position_bias = encoder_inputs(
            model, audio, num_valid)

    wanted = set(range(cfg.num_layers + 1)) if taps is None else set(taps)
    collected: dict[int, torch.Tensor] = {}
    if 0 in wanted:
        collected[0] = x
    n_run = max(wanted)
    for i, p in enumerate(model.encoder["layers"][:n_run], start=1):
        x = encoder_layer(cfg, p, x, key_bias, position_bias, frame_valid, **shard)
        if i in wanted:
            collected[i] = x

    last = cfg.num_layers
    if cfg.do_stable_layer_norm and last in collected:
        collected[last] = _layer_norm(collected[last], model.encoder["layer_norm"],
                                      cfg.layer_norm_eps)

    order = sorted(collected) if taps is None else list(taps)
    if len(order) == 1:
        return collected[order[0]][None], frame_mask
    return torch.stack([collected[i] for i in order], dim=0), frame_mask


def encoder_inputs(model: SpeechEncoder, audio: torch.Tensor, num_valid: torch.Tensor):
    """The forward up to the first transformer layer: input normalisation, the
    conv extractor, the feature projection, the positional conv and (post-norm)
    the encoder layer norm.

    Returns x (B, T_frames, H), frame_mask (B, T_frames), frame_valid (B,),
    the additive key bias (B, 1, 1, T_frames) and, for WavLM, the (H, T, T)
    relative position bias from layer 0's table (None otherwise).
    """
    cfg = model.cfg
    t_samples = audio.shape[1]
    dev = audio.device
    compute_dtype = model.feature_projection["projection"].weight.dtype

    if cfg.do_normalize:
        # HF Wav2Vec2FeatureExtractor zero-mean/unit-var per utterance over
        # valid samples (padding excluded), eps 1e-7, float32 statistics.
        audio = audio.float()
        smask = (torch.arange(t_samples, device=dev)[None, :] < num_valid[:, None]).float()
        n = num_valid.float().clamp(min=1.0)[:, None]
        mean = (audio * smask).sum(dim=1, keepdim=True) / n
        var = ((audio - mean).square() * smask).sum(dim=1, keepdim=True) / n
        audio = (audio - mean) / torch.sqrt(var + 1e-7) * smask
    audio = audio.to(compute_dtype)

    feats, frame_mask, frame_valid = _feature_extractor(
        cfg, model.feature_extractor, audio, num_valid
    )
    fp = model.feature_projection
    x = feats.transpose(1, 2)  # (B, T_frames, C_last)
    if cfg.feat_proj_layer_norm:
        x = _layer_norm(x, fp["layer_norm"], cfg.layer_norm_eps)
    x = linear(fp["projection"], x)

    # Zero padded frames so the positional conv sees the same zeros an unpadded
    # run would have (HF zeroes them when an attention mask is passed).
    x = x * frame_mask[..., None]

    enc = model.encoder
    x = x + pos_conv_embedding(cfg, enc["pos_conv"], x)
    if not cfg.do_stable_layer_norm:
        x = _layer_norm(x, enc["layer_norm"], cfg.layer_norm_eps)

    # Additive key mask: large negative on padded keys (HF _prepare_4d mask).
    neg = torch.finfo(x.dtype).min
    key_bias = (1.0 - frame_mask)[:, None, None, :] * neg

    if cfg.attention_type == "wavlm":  # once per forward, from layer 0's table
        position_bias = wavlm_position_bias(
            cfg, enc["layers"][0]["attention"].rel_attn_embed, x.shape[1]
        )
    else:
        position_bias = None
    return x, frame_mask, frame_valid, key_bias, position_bias
