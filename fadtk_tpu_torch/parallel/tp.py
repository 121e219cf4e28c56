"""Tensor-parallel speech-encoder shards + sharded statistics.

The port of ``fadtk_tpu/parallel/tp.py``: a batch of clips split over the
``dp`` ranks runs through the speech encoder with attention heads and FFN
columns split over the ``tp`` ranks (Megatron-style column/row-parallel
pairs: one ``all_reduce`` on the tp group after each attention block's
out_proj and one after each FFN), and the frames feed per-rank Welford
partials merged across ``dp`` (``metric.stats.welford_merge_across``).

This module holds how the weights are cut (``shard_speech_params``) and the
step; the layers are ``models/speech/encoder.py``'s own, which take the tp
group and the shard's first head. At tp = 1 there is no group and the shard
is the encoder itself, so a single card runs the single-card forward. The
step routes bf16 WavLM to the head-major kernel K2 (``flash_attention``), as
the JAX package's tp step does; the cached path takes K1b.
tests/test_torch_tp.py holds the step against the JAX package's.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..metric.stats import (
    welford_finalize,
    welford_init,
    welford_merge_across,
    welford_update,
)
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


def _tp_forward(cfg: SpeechEncoderConfig, shard: enc.SpeechEncoder, audio, num_valid,
                mesh: Mesh, layer: int):
    """One dp shard's forward with the tp-sharded encoder, up to hidden state
    ``layer``: ``encoder.speech_encoder_forward`` on this rank's heads, with
    the row-parallel sums over ``mesh.tp_group`` and bf16 WavLM on K2.
    WavLM's position bias comes from the shard's layer-0 table, so it holds
    this rank's heads. Returns (B_local, T_frames, H) and the frame mask."""
    states, frame_mask = enc.speech_encoder_forward(
        shard, audio, num_valid, (layer,), tp_group=mesh.tp_group,
        first_head=mesh.tp_rank * (cfg.num_heads // mesh.tp), head_major=True)
    return states[0], frame_mask


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


def make_sharded_eval_step(cfg: SpeechEncoderConfig, encoder: enc.SpeechEncoder, mesh: Mesh,
                           layer: int):
    """Build the evaluation step.

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

    return step
