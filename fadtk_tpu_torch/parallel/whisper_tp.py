"""Tensor-parallel Whisper shards and step (encoder + 2-token decoder).

The port of ``fadtk_tpu/parallel/whisper_tp.py``: Megatron-style
column/row-parallel attention and FFN over the mesh's tp group, for the
whisper-medium / large variants, and the batch split over dp. This module
holds how the weights are cut and the step; the forward is
``models/whisper_impl.py``'s own, which takes the tp group
(tests/test_torch_whisper_tp.py holds this step against the plain forward
and against the JAX package's step):

- column-parallel (output features split, weight and bias): q/k/v of every
  attention block (k_proj has no bias) and fc1;
- row-parallel (input features split): out_proj and fc2, each followed by
  one ``all_reduce`` on the tp group; their biases stay whole and are added
  once, after the reduce, not on every rank.

At tp = 1 there is no group and the shard is the model itself, so one card
runs the plain forward.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn

from ..models import whisper_impl as w
from .mesh import Mesh
from .tp import _to_device


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


def make_sharded_whisper_step(cfg: w.WhisperConfig, mesh: Mesh):
    """Build the step.

    ``step(shard, feats (B, 80, T))`` -> (B, 2, d) float32 embeddings of the
    whole batch on ``mesh.device``: this rank embeds its dp slice of rows
    (B must divide by dp) with ``shard = shard_whisper_params(model, mesh)``,
    and the slices are gathered over dp. The features move to the weights'
    device and dtype.
    """

    @torch.inference_mode()
    def step(shard: w.Whisper, feats):
        if shard.cfg != cfg:
            raise ValueError("make_sharded_whisper_step: shard.cfg differs from cfg")
        b = feats.shape[0]
        if b % mesh.dp:
            raise ValueError(f"batch {b} must divide dp={mesh.dp}")
        rows = b // mesh.dp
        local = _to_device(feats[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows],
                           shard.encoder.conv1.weight.device)
        out = w.whisper_forward(shard, local, mesh.tp_group)
        if mesh.dp_group is None:
            return out
        parts = [torch.empty_like(out) for _ in range(mesh.dp)]
        dist.all_gather(parts, out.contiguous(), group=mesh.dp_group)
        return torch.cat(parts)

    return step
