"""Tensor-parallel speech-encoder forward + sharded statistics.

The port of ``fadtk_tpu/parallel/tp.py``: a batch of clips split over the
``dp`` ranks runs through the speech encoder with attention heads and FFN
columns split over the ``tp`` ranks (Megatron-style column/row-parallel
pairs: one ``all_reduce`` on the tp group after each attention block's
out_proj and one after each FFN), and the frames feed per-rank Welford
partials merged across ``dp`` (``metric.stats.welford_merge_across``). At
tp = 1 every ``all_reduce`` is the identity, so a single card runs the same
code.

The math is that of ``models/speech/encoder.py``, which stays the parity
reference (tests/test_torch_tp.py holds this step against it and against the
JAX package's step). Attention routing follows the JAX package's
``_tp_attention``:

- standard attention (w2v2, HuBERT, MERT) takes the packed kernel K1
  (``flash_attention_packed``) on the shard-local heads;
- WavLM takes the head-major kernel K2 (``flash_attention``) on the
  head-split views of the projections, with the position bias and gate in
  float32 — the only production caller of K2;
- float32 keeps the plain ``_attention_core`` unless ``FADTK_TPU_FLASH_F32=1``
  and T reaches ``FADTK_TPU_FLASH_F32_MIN_T`` (default 640), exactly as
  ``encoder.use_flash_attention`` decides.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..metric.stats import (
    welford_finalize,
    welford_init,
    welford_merge_across,
    welford_update,
)
from ..models.precision import gelu
from ..models.speech import encoder as enc
from ..models.speech.config import SpeechEncoderConfig
from ..runner import profiling
from .mesh import Mesh


def shard_speech_params(encoder: enc.SpeechEncoder, mesh: Mesh) -> enc.SpeechEncoder:
    """This tp rank's shard-local encoder (the counterpart of
    ``speech_param_specs``); the encoder itself at tp = 1.

    Column-parallel (output features split): the q/k/v projections and the
    FFN's ``intermediate_dense``, weight and bias. Row-parallel (input
    features split, bias kept whole and added after the ``all_reduce``):
    ``out_proj`` and ``output_dense``. WavLM's ``gru_rel_pos_const`` and
    ``rel_attn_embed`` split on heads. Everything else is replicated.
    """
    if mesh.tp == 1:
        return encoder

    def part(x: torch.Tensor, dim: int) -> nn.Parameter:
        n = x.shape[dim] // mesh.tp
        return nn.Parameter(x.narrow(dim, mesh.tp_rank * n, n).clone(),
                            requires_grad=x.requires_grad)

    def column(lin: nn.Linear) -> None:
        lin.weight, lin.bias = part(lin.weight, 0), part(lin.bias, 0)
        lin.out_features = lin.weight.shape[0]

    def row(lin: nn.Linear) -> None:
        lin.weight = part(lin.weight, 1)
        lin.in_features = lin.weight.shape[1]

    shard = copy.deepcopy(encoder)
    with torch.no_grad():
        for layer in shard.encoder["layers"]:
            attn, ff = layer["attention"], layer["feed_forward"]
            for lin in (attn.q_proj, attn.k_proj, attn.v_proj, ff["intermediate_dense"]):
                column(lin)
            for lin in (attn.out_proj, ff["output_dense"]):
                row(lin)
            if encoder.cfg.attention_type == "wavlm":
                attn.gru_rel_pos_const = part(attn.gru_rel_pos_const, 0)
                if hasattr(attn, "rel_attn_embed"):
                    attn.rel_attn_embed = part(attn.rel_attn_embed, 1)
    return shard


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the tp group: the identity when the axis has one rank."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _tp_attention(cfg, p: enc.Attention, x, key_bias, position_bias, mesh: Mesh,
                  frame_valid=None):
    """Head-sharded attention: local heads contract, all_reduce after out_proj."""
    local_heads = p.q_proj.weight.shape[0] // cfg.head_dim

    q = p.q_proj(x)
    k = p.k_proj(x)
    v = p.v_proj(x)

    def split(t):
        b, s, _ = t.shape
        return t.view(b, s, local_heads, cfg.head_dim).transpose(1, 2)

    # f32 long-bucket flash applies only to the unbiased (standard) form;
    # the WavLM factorized bias keeps the plain path in f32 (encoder.py).
    wavlm = cfg.attention_type == "wavlm"
    flash = enc.use_flash_attention(x.dtype, frame_valid, None if wavlm else x.shape[1],
                                    x.device)
    bias = key_bias
    if wavlm:
        # This rank's heads of the replicated activations; through the
        # module attribute, so that a caller can wrap it.
        gate, bias = enc.wavlm_gated_bias(cfg, p, x, position_bias, key_bias,
                                          first_head=mesh.tp_rank * local_heads,
                                          dense=not flash)
    if flash:
        from ..ops.flash_attention import flash_attention, flash_attention_packed

        if not wavlm:
            # Packed-heads kernel on the shard-local projection layout.
            out = flash_attention_packed(q, k, v, frame_valid, num_heads=local_heads)
        else:
            # WavLM's bias streams factorized: local-head gate x local-head
            # position-bias slice, through the head-split views in place.
            o = flash_attention(split(q), split(k), split(v), frame_valid,
                                position_bias=position_bias.float(),
                                gate=gate.transpose(1, 2).float())
            b, h, t, d = o.shape
            out = o.transpose(1, 2).reshape(b, t, h * d)
    else:
        out = enc._attention_core(split(q), split(k), split(v), bias)
    out = _all_reduce(F.linear(out, p.out_proj.weight), mesh.tp_group)
    return out + p.out_proj.bias


def _tp_feed_forward(p: nn.ModuleDict, x, mesh: Mesh):
    h = gelu(p["intermediate_dense"](x))
    y = _all_reduce(F.linear(h, p["output_dense"].weight), mesh.tp_group)
    return y + p["output_dense"].bias


def _tp_encoder_layer(cfg, p: nn.ModuleDict, x, key_bias, position_bias, mesh: Mesh,
                      frame_valid=None):
    eps = cfg.layer_norm_eps

    def attn(y):
        with profiling.stage("model.attention"):
            return _tp_attention(cfg, p["attention"], y, key_bias, position_bias, mesh,
                                 frame_valid)

    def ffn(y):
        with profiling.stage("model.ffn"):
            return _tp_feed_forward(p["feed_forward"], y, mesh)

    if cfg.do_stable_layer_norm:
        x = x + attn(enc._layer_norm(x, p["layer_norm"], eps))
        x = x + ffn(enc._layer_norm(x, p["final_layer_norm"], eps))
    else:
        x = enc._layer_norm(x + attn(x), p["layer_norm"], eps)
        x = enc._layer_norm(x + ffn(x), p["final_layer_norm"], eps)
    return x


def _tp_forward(cfg: SpeechEncoderConfig, shard: enc.SpeechEncoder, audio, num_valid,
                mesh: Mesh, layer: int):
    """One dp shard's forward with the tp-sharded encoder, up to hidden state
    ``layer``: ``encoder.speech_encoder_forward`` with the row-parallel sums.
    WavLM's position bias comes from the shard's layer-0 table, so it holds
    this rank's heads. Returns (B_local, T_frames, H) and the frame mask."""
    with profiling.stage("model.extractor"):
        x, frame_mask, frame_valid, key_bias, position_bias = enc.encoder_inputs(
            shard, audio, num_valid)
    for p in shard.encoder["layers"][:layer]:
        x = _tp_encoder_layer(cfg, p, x, key_bias, position_bias, mesh, frame_valid)
    if cfg.do_stable_layer_norm and layer == cfg.num_layers:
        x = enc._layer_norm(x, shard.encoder["layer_norm"], cfg.layer_norm_eps)
    return x, frame_mask


def _pinned(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory()
    return x


def _to_device(x, device: torch.device) -> torch.Tensor:
    """Host arrays go up through pinned memory without blocking the host."""
    return _pinned(x, device).to(device, non_blocking=True)


def _step_inputs(device: torch.device, *arrays) -> list[torch.Tensor]:
    """A step's arrays on ``device`` as ``_to_device`` puts them, with the
    step's start mark (runner/profiling.py) between the pinning and the
    first copy."""
    pinned = [_pinned(x, device) for x in arrays]
    profiling.step_start(device)
    return [x.to(device, non_blocking=True) for x in pinned]


# Steps memoised per (cfg, mesh, layer), as the JAX package's _EVAL_STEP_CACHE:
# a step captures only those three; the shard-local encoder is an argument.
_EVAL_STEP_CACHE: dict = {}


def make_sharded_eval_step(cfg: SpeechEncoderConfig, encoder: enc.SpeechEncoder, mesh: Mesh,
                           layer: int):
    """Build (or return the memoised) evaluation step.

    ``step(shard, audio (B, T), num_valid (B,))`` -> (mu, cov, n), the
    dataset-statistics partials of the *whole* batch on ``mesh.device``.
    ``shard`` is ``shard_speech_params(encoder, mesh)``; ``audio`` and
    ``num_valid`` are the global batch (host or device), of which this rank
    embeds its dp slice of rows. The frames stay on the device, round-trip
    through float16 (the cached path's storage format, reference
    fadtk/model_loader.py:47-48) and fold into a Welford state; only the
    (D,), (D, D) and () results come back.
    """
    if encoder.cfg != cfg:
        raise ValueError("make_sharded_eval_step: encoder.cfg differs from cfg")
    key = (cfg, mesh, layer)
    cached = _EVAL_STEP_CACHE.get(key)
    if cached is not None:
        return cached

    @torch.inference_mode()
    def step(shard: enc.SpeechEncoder, audio, num_valid):
        b = audio.shape[0]
        if b % mesh.dp:
            raise ValueError(f"batch {b} must divide dp={mesh.dp}")
        lo = mesh.dp_rank * (b // mesh.dp)
        rows = slice(lo, lo + b // mesh.dp)
        audio_d, num_valid_d = _step_inputs(mesh.device, audio[rows], num_valid[rows])
        frames, frame_mask = _tp_forward(cfg, shard, audio_d, num_valid_d, mesh, layer)
        with profiling.stage("step.stats"):
            d = frames.shape[-1]
            flat = frames.reshape(-1, d).to(torch.float16).float()
            st = welford_update(welford_init(d, device=flat.device), flat, frame_mask.reshape(-1))
            st = welford_merge_across(st, mesh.dp_group)
            mu, cov = welford_finalize(st)
        return mu, cov, st.n

    _EVAL_STEP_CACHE[key] = step
    return step
