"""The Whisper family (whisper-large) for the benchmark: its seeded weights,
the program's model loaded with them, the reference's per-file moments
(``portbench/reference/whisper.py``), the clip lengths and the FLOPs a clip
needs.

Weights are drawn on the device from the seed in one call (a flat uniform
buffer on [-1, 1) cut into the leaves), in float32, and scaled per leaf as
the speech family's are: linear and conv kernels U(+-1/sqrt(fan in)),
biases U(+-0.02), LayerNorm scales 1 + U(+-0.1) and shifts U(+-0.1), the
token and decoder-position embeddings U(+-1), so that every bias and norm
term takes part. The encoder's positions are the sinusoids as published
(``reference.whisper.sinusoids``), not drawn. Every clip meets the same two
tokens, so the decoder's frames differ from clip to clip only through its
attention onto the encoder; its q and k projections are drawn 3 times wider
than the rule (logits of order 1 per head instead of 0.3, so that each
query picks out frames rather than averaging all 1500) and its v and out
projections twice as wide, so that the clip's part of the frames stands
well above the float32 rounding and a fault in the encoder or in the
frontend moves the statistics by far.

FLOPs: one 30 s window a clip, whatever its length: the model computes on
the padding, or on the first 30 s, by definition. A multiply-add counts 2;
elementwise work (norms, GELU, softmax, residual sums) is left out, as
``portbench/flops.py`` leaves it out.
"""

from __future__ import annotations

import math
import types
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..reference import audio as ref_audio
from ..reference import gaussian
from ..reference import whisper as ref_whisper
from .speech import model_samples, registry_model  # noqa: F401  (the family's interface)

_SEED_STREAM = 0x3B1
# Configuration keys -> WhisperConfig fields of the program.
_PROGRAM_FIELDS = {
    "d_model": "d_model", "encoder_layers": "encoder_layers",
    "encoder_attention_heads": "encoder_heads", "decoder_layers": "decoder_layers",
    "decoder_attention_heads": "decoder_heads", "encoder_ffn_dim": "encoder_ffn",
    "decoder_ffn_dim": "decoder_ffn", "num_mel_bins": "num_mel_bins",
    "max_source_positions": "max_source_positions",
    "max_target_positions": "max_target_positions", "vocab_size": "vocab_size",
    "layer_norm_eps": "layer_norm_eps",
}
_CROSS_QK, _CROSS_VO = 3.0, 2.0


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every drawn weight; kind: "u" (uniform
    times scale), "norm" (1 + uniform times scale)."""
    d, mels = cfg["d_model"], cfg["num_mel_bins"]

    def linear(name, n_out, n_in, bias=True, wide=1.0):
        out = [(f"{name}.weight", (n_out, n_in), "u", wide / math.sqrt(n_in))]
        return out + ([(f"{name}.bias", (n_out,), "u", 0.02)] if bias else [])

    def norm(name):
        return [(f"{name}.weight", (d,), "norm", 0.1), (f"{name}.bias", (d,), "u", 0.1)]

    def attention(name, qk=1.0, vo=1.0):
        return (linear(f"{name}.q_proj", d, d, wide=qk) + linear(f"{name}.k_proj", d, d, False, qk)
                + linear(f"{name}.v_proj", d, d, wide=vo) + linear(f"{name}.out_proj", d, d, wide=vo))

    def ffn(p, f):
        return linear(f"{p}.fc1", f, d) + linear(f"{p}.fc2", d, f) + norm(f"{p}.final_layer_norm")

    out = [("encoder.conv1.weight", (d, mels, 3), "u", 1 / math.sqrt(3 * mels)),
           ("encoder.conv1.bias", (d,), "u", 0.02),
           ("encoder.conv2.weight", (d, d, 3), "u", 1 / math.sqrt(3 * d)),
           ("encoder.conv2.bias", (d,), "u", 0.02)]
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.layers.{i}"
        out += attention(f"{p}.self_attn") + norm(f"{p}.self_attn_layer_norm")
        out += ffn(p, cfg["encoder_ffn_dim"])
    out += norm("encoder.layer_norm")
    out += [("decoder.embed_tokens", (cfg["vocab_size"], d), "u", 1.0),
            ("decoder.embed_positions", (cfg["max_target_positions"], d), "u", 1.0)]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.layers.{i}"
        out += attention(f"{p}.self_attn") + norm(f"{p}.self_attn_layer_norm")
        out += attention(f"{p}.encoder_attn", _CROSS_QK, _CROSS_VO)
        out += norm(f"{p}.encoder_attn_layer_norm")
        out += ffn(p, cfg["decoder_ffn_dim"])
    return out + norm("decoder.layer_norm")


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63) ^ _SEED_STREAM)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    weights, at = {}, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape).mul_(scale)
        weights[name] = x.add_(1) if kind == "norm" else x
        at += n
    weights["encoder.embed_positions"] = ref_whisper.sinusoids(
        cfg["max_source_positions"], cfg["d_model"], device)
    return weights


def program_model(cfg: dict, weights: dict[str, torch.Tensor]):
    """The program's registry model of ``cfg["model"]``, loaded with
    ``weights`` through its state dict by the program's own
    ``ensure_loaded`` (which sets the precision policy), with the file's
    decoder start token, as a converted checkpoint's configuration sets it.
    Raises if the program's configuration of that model is not the file's."""
    from fadtk_tpu_torch.models.whisper_impl import Whisper
    from fadtk_tpu_torch.utils import resolve_device

    model = registry_model(cfg["model"])
    differs = {k: (cfg[k], getattr(model.cfg, f)) for k, f in _PROGRAM_FIELDS.items()
               if cfg[k] != getattr(model.cfg, f)}
    if model.sr != cfg["sampling_rate"] or model.BATCH != cfg["batch_per_card"]:
        differs["sampling_rate/batch"] = ((cfg["sampling_rate"], cfg["batch_per_card"]),
                                          (model.sr, model.BATCH))
    if differs:
        raise ValueError(f"{cfg['model']}: the program's configuration is not the file's: {differs}")
    model.cfg = replace(model.cfg, decoder_start_token_id=cfg["decoder_start_token_id"])

    def load_model(self):
        self.device = resolve_device()
        with torch.device("meta"):
            module = Whisper(self.cfg)
        module.load_state_dict(weights, strict=True, assign=True)
        self.module = module

    model.load_model = types.MethodType(load_model, model)
    model.ensure_loaded()
    return model


def reference_moments(cfg: dict, weights: dict[str, torch.Tensor], files: list[Path],
                      device, tf32: bool = False) -> gaussian.FileMoments:
    """Per-file moments of the reference's two frames: each pool file
    converted by the reference and embedded alone, with TF32 off
    (``tf32=True``: the control)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            frames = (ref_whisper.forward(cfg, weights, ref_audio.converted_clip(
                f, cfg["sampling_rate"], device).float()) for f in files)
            return gaussian.frame_moments(frames)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def batch_shape(cfg: dict, samples: np.ndarray) -> int:
    """Every batch is of 30 s windows, whatever its clips' lengths."""
    return cfg["n_samples"]


def clip_flops(cfg: dict, samples: int) -> int:
    """Model FLOPs of one window (``samples`` does not enter): the two
    convolutions; per encoder layer the four projections, the feed-forward,
    q k^T and p v over T = 1500 frames; per decoder layer, for its 2 tokens,
    the self-attention's projections and products, the cross-attention's q
    and out projections, its k and v projections of the T encoder states
    and its products over them, and the feed-forward."""
    d, mels = cfg["d_model"], cfg["num_mel_bins"]
    t = cfg["max_source_positions"]
    frames = 2 * t
    stem = 2 * frames * d * mels * 3 + 2 * t * d * d * 3
    enc = 2 * t * d * d * 4 + 2 * t * d * cfg["encoder_ffn_dim"] * 2 + 2 * t * t * d * 2
    n = 2
    dec = (2 * n * d * d * 4 + 2 * n * n * d * 2  # self-attention
           + 2 * n * d * d * 2 + 2 * t * d * d * 2 + 2 * n * t * d * 2  # cross-attention
           + 2 * n * d * cfg["decoder_ffn_dim"] * 2)
    return stem + cfg["encoder_layers"] * enc + cfg["decoder_layers"] * dec
