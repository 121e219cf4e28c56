"""The WavLM family (wavlm-large) for the benchmark: the speech family's
weights, model, clip lengths and FLOPs, plus WavLM's attention leaves and
its own reference (``portbench/reference/wavlm_encoder.py``).

WavLM's leaves come from a second stream of the seed, drawn as the speech
family draws its own (uniform on [-1, 1), scaled per leaf), and large
enough that a program which drops the bias, the gate or a bucket fails the
comparison by far: the relative-position table U(+-3) (the program's own
init draws std 0.02, which would leave logits of order 0.3 nearly
untouched; at a tiny size on the CPU, U(+-1) moved the statistics 2.5-5
times less than U(+-3) under each such fault), the gate projection
U(+-1/sqrt(head_dim)) with biases U(+-0.5), so that each head's gate swings
over much of its range (1, 2) from frame to frame, and the gate constants
1 + U(+-0.5).

FLOPs: ``flops.speech_clip_flops`` as it is; the gate and the bias are
elementwise work, which its convention leaves out.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from ..reference import audio as ref_audio
from ..reference import gaussian
from ..reference import wavlm_encoder as ref_encoder
from . import speech
from .speech import batch_shape, clip_flops, model_samples  # noqa: F401  (the family's interface)

_SECOND_STREAM = 0x3A7


def wavlm_leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of the leaves WavLM's attention adds to
    the speech family's, as in ``speech.leaves``."""
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    out = [("encoder.layers.0.attention.rel_attn_embed", (cfg["num_buckets"], heads), "u", 3.0)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layers.{i}.attention"
        out += [(f"{p}.gru_rel_pos_linear.weight", (8, d), "u", 1 / math.sqrt(d)),
                (f"{p}.gru_rel_pos_linear.bias", (8,), "u", 0.5),
                (f"{p}.gru_rel_pos_const", (heads,), "norm", 0.5)]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    weights = speech.make_weights(cfg, seed, device)
    spec = wavlm_leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63) ^ _SECOND_STREAM)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    at = 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape) * scale
        weights[name] = x + 1 if kind == "norm" else x
        at += n
    return weights


def program_model(cfg: dict, weights: dict[str, torch.Tensor]):
    """``speech.program_model``, which also holds the file's relative-position
    buckets and distance against the program's configuration of the model."""
    model = speech.registry_model(cfg["model"])
    differs = {k: (cfg[k], getattr(model.cfg, k)) for k in ("num_buckets", "max_bucket_distance")
               if cfg[k] != getattr(model.cfg, k)}
    if differs:
        raise ValueError(f"{cfg['model']}: the program's configuration is not the file's: {differs}")
    return speech.program_model(cfg, weights)


def reference_moments(cfg: dict, weights: dict[str, torch.Tensor], files: list[Path],
                      device, tf32: bool = False) -> gaussian.FileMoments:
    """Per-file moments of the WavLM reference's tapped states, each pool file
    converted by the reference and run alone at its own length, with TF32
    off (``tf32=True``: the control)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            frames = (ref_encoder.forward(cfg, weights, ref_audio.converted_clip(
                f, cfg["sampling_rate"], device).float(), cfg["layer"]) for f in files)
            return gaussian.frame_moments(frames)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
