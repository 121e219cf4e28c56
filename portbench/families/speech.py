"""The speech-encoder family (w2v2, HuBERT, MERT) for the benchmark: its
seeded weights, the program's model loaded with them, the reference's
per-file moments, and the FLOPs a clip needs.

Weights are drawn on the device from the seed in one call (a flat uniform
buffer on [-1, 1) cut into the leaves), in float32, the type the float32
configurations serve in, and scaled per leaf: linear kernels U(+-1/sqrt(in)),
conv-extractor kernels with std 0.5/sqrt(k in), the positional kernel with
std 0.02, biases U(+-0.02), norm scales 1 + U(+-0.1) and norm shifts
U(+-0.1), so that every bias and norm term takes part. The same tensors go
into the program's encoder (through its state dict) and to the reference.
"""

from __future__ import annotations

import math
import types
from pathlib import Path

import numpy as np
import torch

from ..flops import speech_clip_flops
from ..reference import audio as ref_audio
from ..reference import gaussian
from ..reference import speech_encoder as ref_encoder

# Configuration keys -> SpeechEncoderConfig fields of the program.
_PROGRAM_FIELDS = {
    "conv_dim": "conv_dim", "conv_kernel": "conv_kernel", "conv_stride": "conv_stride",
    "conv_bias": "conv_bias", "feat_extract_norm": "feat_extract_norm",
    "feat_proj_layer_norm": "feat_proj_layer_norm", "hidden_size": "hidden_size",
    "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
    "intermediate_size": "intermediate_size", "do_stable_layer_norm": "do_stable_layer_norm",
    "layer_norm_eps": "layer_norm_eps", "num_conv_pos_embeddings": "num_conv_pos_embeddings",
    "num_conv_pos_embedding_groups": "num_conv_pos_embedding_groups",
    "attention_type": "attention_type", "do_normalize": "do_normalize",
}


def leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every weight; kind: "u" (uniform times
    scale), "norm" (1 + uniform times scale)."""
    out = []
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        out.append((f"{p}.conv.weight", (c, c_in, k), "u", math.sqrt(3) * 0.5 / math.sqrt(k * c_in)))
        if cfg["conv_bias"]:
            out.append((f"{p}.conv.bias", (c,), "u", 0.02))
        if (cfg["feat_extract_norm"] == "group" and i == 0) or cfg["feat_extract_norm"] == "layer":
            out += [(f"{p}.layer_norm.weight", (c,), "norm", 0.1),
                    (f"{p}.layer_norm.bias", (c,), "u", 0.1)]
        c_in = c
    h, f = cfg["hidden_size"], cfg["intermediate_size"]

    def linear(name, n_out, n_in):
        return [(f"{name}.weight", (n_out, n_in), "u", 1 / math.sqrt(n_in)),
                (f"{name}.bias", (n_out,), "u", 0.02)]

    def norm(name, n):
        return [(f"{name}.weight", (n,), "norm", 0.1), (f"{name}.bias", (n,), "u", 0.1)]

    if cfg["feat_proj_layer_norm"]:
        out += norm("feature_projection.layer_norm", c_in)
    out += linear("feature_projection.projection", h, c_in)
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    out += [("encoder.pos_conv.weight", (h, h // g, k), "u", math.sqrt(3) * 0.02),
            ("encoder.pos_conv.bias", (h,), "u", 0.02)]
    out += norm("encoder.layer_norm", h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += linear(f"{p}.attention.{n}", h, h)
        out += norm(f"{p}.layer_norm", h)
        out += linear(f"{p}.feed_forward.intermediate_dense", f, h)
        out += linear(f"{p}.feed_forward.output_dense", h, f)
        out += norm(f"{p}.final_layer_norm", h)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
    weights, at = {}, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape) * scale
        weights[name] = x + 1 if kind == "norm" else x
        at += n
    return weights


def program_model(cfg: dict, weights: dict[str, torch.Tensor]):
    """The program's registry model of ``cfg["model"]``, loaded with
    ``weights`` through its state dict by the program's own
    ``ensure_loaded`` (which sets the precision policy). Raises if the
    program's configuration of that model is not the file's."""
    from fadtk_tpu_torch.models.speech.encoder import SpeechEncoder
    from fadtk_tpu_torch.utils import resolve_device

    model = registry_model(cfg["model"])
    differs = {k: (cfg[k], getattr(model.cfg, f)) for k, f in _PROGRAM_FIELDS.items()
               if _norm(cfg[k]) != _norm(getattr(model.cfg, f))}
    if model.sr != cfg["sampling_rate"] or model.layer != cfg["layer"]:
        differs["sampling_rate/layer"] = ((cfg["sampling_rate"], cfg["layer"]),
                                          (model.sr, model.layer))
    if differs:
        raise ValueError(f"{cfg['model']}: the program's configuration is not the file's: {differs}")

    def load_model(self):
        self.device = resolve_device()
        with torch.device("meta"):
            module = SpeechEncoder(self.cfg)
        module.load_state_dict(weights, strict=True, assign=True)
        self.module = module

    model.load_model = types.MethodType(load_model, model)
    model.ensure_loaded()
    return model


def registry_model(name: str):
    from fadtk_tpu_torch.models.registry import get_all_models

    return next(m for m in get_all_models() if m.name == name)


def _norm(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def reference_moments(cfg: dict, weights: dict[str, torch.Tensor], files: list[Path],
                      device, tf32: bool = False) -> gaussian.FileMoments:
    """Per-file moments of the reference's tapped states: each pool file
    decoded, downmixed, resampled and quantised by the reference, then run
    alone at its own length, with TF32 off (``tf32=True``: the control)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            frames = (ref_encoder.forward(cfg, weights, ref_audio.converted_clip(
                f, cfg["sampling_rate"], device).float(), cfg["layer"]) for f in files)
            return gaussian.frame_moments(frames)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def model_samples(cfg: dict, source_samples: np.ndarray, source_rate: int) -> np.ndarray:
    """Clip lengths at the model's rate (the resample's ceil rule)."""
    g = math.gcd(source_rate, cfg["sampling_rate"])
    orig, new = source_rate // g, cfg["sampling_rate"] // g
    return -(-new * source_samples // orig)


def batch_shape(cfg: dict, samples: np.ndarray) -> int:
    """The padded length of a batch of clips of ``samples`` (model samples):
    the program's bucket, the longest clip up to a multiple of its
    ``BUCKET_SECONDS``."""
    from fadtk_tpu_torch.models.speech.family import BUCKET_SECONDS

    step = BUCKET_SECONDS * cfg["sampling_rate"]
    return -(-int(np.max(samples)) // step) * step


def clip_flops(cfg: dict, samples: int) -> int:
    return speech_clip_flops(cfg, int(samples), cfg["layer"])
