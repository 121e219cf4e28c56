"""Tensor-parallel Whisper forward (encoder + 2-token decoder).

The port of ``fadtk_tpu/parallel/whisper_tp.py``: Megatron-style
column/row-parallel attention and FFN over the mesh's tp group, for the
whisper-medium / large variants, and the batch split over dp. The math is
``models/whisper_impl.py``'s (tests/test_torch_whisper_tp.py holds this step
against it and against the JAX package's step):

- column-parallel (output features split, weight and bias): q/k/v of every
  attention block (k_proj has no bias) and fc1;
- row-parallel (input features split): out_proj and fc2, each followed by
  one ``all_reduce`` on the tp group; their biases stay whole and are added
  once, after the reduce, not on every rank.

At tp = 1 every ``all_reduce`` is the identity, so one card runs the same
code.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models import whisper_impl as w
from ..models.precision import gelu
from .mesh import Mesh
from .tp import _all_reduce, _to_device


def shard_whisper_params(model: w.Whisper, mesh: Mesh) -> w.Whisper:
    """This tp rank's shard-local Whisper (the counterpart of
    ``whisper_param_specs``); the model itself at tp = 1. tp must divide the
    encoder's and the decoder's heads."""
    cfg = model.cfg
    if cfg.encoder_heads % mesh.tp or cfg.decoder_heads % mesh.tp:
        raise ValueError(f"tp={mesh.tp} must divide the encoder heads ({cfg.encoder_heads}) "
                         f"and the decoder heads ({cfg.decoder_heads})")
    if mesh.tp == 1:
        return model

    def part(x: torch.Tensor, dim: int) -> nn.Parameter:
        n = x.shape[dim] // mesh.tp
        return nn.Parameter(x.narrow(dim, mesh.tp_rank * n, n).clone(),
                            requires_grad=x.requires_grad)

    def column(lin: nn.Linear) -> None:
        lin.weight = part(lin.weight, 0)
        if lin.bias is not None:
            lin.bias = part(lin.bias, 0)
        lin.out_features = lin.weight.shape[0]

    def row(lin: nn.Linear) -> None:
        lin.weight = part(lin.weight, 1)
        lin.in_features = lin.weight.shape[1]

    shard = copy.deepcopy(model)
    with torch.no_grad():
        for layer in [*shard.encoder.layers, *shard.decoder.layers]:
            for name in ("self_attn", "encoder_attn"):
                if name in layer:
                    attn = layer[name]
                    for lin in (attn.q_proj, attn.k_proj, attn.v_proj):
                        column(lin)
                    row(attn.out_proj)
            column(layer["fc1"])
            row(layer["fc2"])
    return shard


def _tp_attention(p: w.Attention, x, kv, local_heads: int, mesh: Mesh, causal: bool = False):
    """``whisper_impl._attention`` on the shard-local heads; the out_proj
    partial sums reduce over tp before its bias."""
    b, tq, _ = x.shape
    tk = kv.shape[1]
    hd = p.q_proj.weight.shape[0] // local_heads

    def split(t, tlen):
        return t.reshape(b, tlen, local_heads, hd).transpose(1, 2)

    q = split(p.q_proj(x), tq) * (hd ** -0.5)
    k = split(p.k_proj(kv), tk)
    v = split(p.v_proj(kv), tk)
    logits = q @ k.transpose(-1, -2)
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    out = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, tq, -1)
    out = _all_reduce(F.linear(out, p.out_proj.weight), mesh.tp_group)
    return out + p.out_proj.bias


def _tp_ffn(p: nn.ModuleDict, x, mesh: Mesh):
    h = gelu(p["fc1"](x))
    return _all_reduce(F.linear(h, p["fc2"].weight), mesh.tp_group) + p["fc2"].bias


def _tp_whisper_forward(shard: w.Whisper, feats: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One dp shard's (B_local, 80, T) features -> (B_local, 2, d) float32
    decoder states, with the tp-sharded layers."""
    cfg = shard.cfg
    eps = cfg.layer_norm_eps
    enc_heads, dec_heads = cfg.encoder_heads // mesh.tp, cfg.decoder_heads // mesh.tp
    enc, dec = shard.encoder, shard.decoder
    x = gelu(enc.conv1(feats))
    x = gelu(enc.conv2(x)).transpose(1, 2)
    x = x + enc.embed_positions[None, : x.shape[1]]
    for p in enc.layers:
        h = w._ln(x, p["self_attn_layer_norm"], eps)
        x = x + _tp_attention(p["self_attn"], h, h, enc_heads, mesh)
        x = x + _tp_ffn(p, w._ln(x, p["final_layer_norm"], eps), mesh)
    enc_states = w._ln(x, enc.layer_norm, eps)

    tokens = torch.full((feats.shape[0], 2), cfg.decoder_start_token_id, dtype=torch.long,
                        device=feats.device)
    x = dec.embed_tokens[tokens] + dec.embed_positions[None, :2]
    for p in dec.layers:
        h = w._ln(x, p["self_attn_layer_norm"], eps)
        x = x + _tp_attention(p["self_attn"], h, h, dec_heads, mesh, causal=True)
        x = x + _tp_attention(p["encoder_attn"], w._ln(x, p["encoder_attn_layer_norm"], eps),
                              enc_states, dec_heads, mesh)
        x = x + _tp_ffn(p, w._ln(x, p["final_layer_norm"], eps), mesh)
    return w._ln(x, dec.layer_norm, eps).float()


# Steps memoised per (cfg, mesh), as the JAX package's _WHISPER_STEP_CACHE;
# the shard-local model is an argument.
_WHISPER_STEP_CACHE: dict = {}


def make_sharded_whisper_step(cfg: w.WhisperConfig, mesh: Mesh):
    """Build (or return the memoised) step.

    ``step(shard, feats (B, 80, T))`` -> (B, 2, d) float32 embeddings of the
    whole batch on ``mesh.device``: this rank embeds its dp slice of rows
    (B must divide by dp) with ``shard = shard_whisper_params(model, mesh)``,
    and the slices are gathered over dp. The features move to the weights'
    device and dtype.
    """
    key = (cfg, mesh)
    cached = _WHISPER_STEP_CACHE.get(key)
    if cached is not None:
        return cached

    @torch.inference_mode()
    def step(shard: w.Whisper, feats):
        if shard.cfg != cfg:
            raise ValueError("make_sharded_whisper_step: shard.cfg differs from cfg")
        b = feats.shape[0]
        if b % mesh.dp:
            raise ValueError(f"batch {b} must divide dp={mesh.dp}")
        rows = b // mesh.dp
        wt = shard.encoder.conv1.weight
        local = _to_device(feats[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows], wt.device)
        out = _tp_whisper_forward(shard, local.to(wt.dtype), mesh)
        if mesh.dp_group is None:
            return out
        parts = [torch.empty_like(out) for _ in range(mesh.dp)]
        dist.all_gather(parts, out.contiguous(), group=mesh.dp_group)
        return torch.cat(parts)

    _WHISPER_STEP_CACHE[key] = step
    return step
