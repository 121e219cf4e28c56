"""Checkpoint -> parameter tree conversion for Whisper (HF WhisperModel state_dict).

The port of ``fadtk_tpu/weights/whisper.py``, line for line: the tree is the
JAX package's, saved as the same flat ``.npz``."""

from __future__ import annotations

import numpy as np

from ..models.whisper_impl import WhisperConfig


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), dtype=np.float32)


def _dense(sd, prefix, bias=True):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if bias:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _norm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _conv(sd, prefix):
    return {
        "kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0),
        "bias": _t(sd[f"{prefix}.bias"]),
    }


def _attn(sd, prefix):
    return {
        "q_proj": _dense(sd, f"{prefix}.q_proj"),
        "k_proj": _dense(sd, f"{prefix}.k_proj", bias=False),
        "v_proj": _dense(sd, f"{prefix}.v_proj"),
        "out_proj": _dense(sd, f"{prefix}.out_proj"),
    }


def convert_whisper(state_dict, cfg: WhisperConfig) -> dict:
    sd = state_dict
    if any(k.startswith("model.") for k in sd):  # ForConditionalGeneration wrapper
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"encoder.layers.{i}"
        enc_layers.append(
            {
                "self_attn": _attn(sd, f"{p}.self_attn"),
                "self_attn_layer_norm": _norm(sd, f"{p}.self_attn_layer_norm"),
                "fc1": _dense(sd, f"{p}.fc1"),
                "fc2": _dense(sd, f"{p}.fc2"),
                "final_layer_norm": _norm(sd, f"{p}.final_layer_norm"),
            }
        )
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"decoder.layers.{i}"
        dec_layers.append(
            {
                "self_attn": _attn(sd, f"{p}.self_attn"),
                "self_attn_layer_norm": _norm(sd, f"{p}.self_attn_layer_norm"),
                "encoder_attn": _attn(sd, f"{p}.encoder_attn"),
                "encoder_attn_layer_norm": _norm(sd, f"{p}.encoder_attn_layer_norm"),
                "fc1": _dense(sd, f"{p}.fc1"),
                "fc2": _dense(sd, f"{p}.fc2"),
                "final_layer_norm": _norm(sd, f"{p}.final_layer_norm"),
            }
        )

    return {
        "encoder": {
            "conv1": _conv(sd, "encoder.conv1"),
            "conv2": _conv(sd, "encoder.conv2"),
            "embed_positions": _t(sd["encoder.embed_positions.weight"]),
            "layers": enc_layers,
            "layer_norm": _norm(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": _t(sd["decoder.embed_tokens.weight"]),
            "embed_positions": _t(sd["decoder.embed_positions.weight"]),
            "layers": dec_layers,
            "layer_norm": _norm(sd, "decoder.layer_norm"),
        },
    }
