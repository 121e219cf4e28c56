"""Checkpoint -> parameter tree conversion for the EnCodec encoder.

The port of ``fadtk_tpu/weights/encodec.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

Accepts an HF transformers EncodecModel state_dict (facebook/encodec_24khz /
encodec_48khz) or the original facebookresearch/encodec checkpoint (same tree
under ``encoder.model.*`` instead of ``encoder.layers.*``). Weight-normed convs
are materialized (g * v / ||v|| over dims (1, 2), torch weight_norm dim=0).
"""

from __future__ import annotations

import numpy as np

from ..models.encodec_impl import EncodecEncoderConfig, encoder_plan


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _conv(sd, prefix, norm_type):
    if f"{prefix}.conv.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{prefix}.conv.parametrizations.weight.original0"])
        v = _t(sd[f"{prefix}.conv.parametrizations.weight.original1"])
        norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    elif f"{prefix}.conv.weight_g" in sd:
        g = _t(sd[f"{prefix}.conv.weight_g"])
        v = _t(sd[f"{prefix}.conv.weight_v"])
        norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    else:
        w = _t(sd[f"{prefix}.conv.weight"])
    out = {"kernel": w, "bias": _t(sd[f"{prefix}.conv.bias"])}
    if norm_type == "time_group_norm":
        out["norm_scale"] = _t(sd[f"{prefix}.norm.weight"])
        out["norm_bias"] = _t(sd[f"{prefix}.norm.bias"])
    return out


def convert_encodec_encoder(state_dict, cfg: EncodecEncoderConfig) -> dict:
    sd = dict(state_dict)
    # Original encodec package tree: encoder.model.{i}. -> encoder.layers.{i}.
    if any(k.startswith("encoder.model.") for k in sd):
        sd = {
            k.replace("encoder.model.", "encoder.layers.", 1): v for k, v in sd.items()
        }

    layers: dict = {}
    for kind, idx, _meta in encoder_plan(cfg):
        prefix = f"encoder.layers.{idx}"
        if kind == "conv":
            layers[str(idx)] = _conv(sd, prefix, cfg.norm_type)
        elif kind == "resnet":
            entry = {
                # HF block ModuleList: 0=ELU, 1=conv, 2=ELU, 3=conv.
                "block_conv1": _conv(sd, f"{prefix}.block.1", cfg.norm_type),
                "block_conv2": _conv(sd, f"{prefix}.block.3", cfg.norm_type),
            }
            if cfg.use_conv_shortcut:
                entry["shortcut"] = _conv(sd, f"{prefix}.shortcut", cfg.norm_type)
            layers[str(idx)] = entry
        elif kind == "lstm":
            layers[str(idx)] = {
                "layers": [
                    {
                        "w_ih": _t(sd[f"{prefix}.lstm.weight_ih_l{j}"]),
                        "w_hh": _t(sd[f"{prefix}.lstm.weight_hh_l{j}"]),
                        "b_ih": _t(sd[f"{prefix}.lstm.bias_ih_l{j}"]),
                        "b_hh": _t(sd[f"{prefix}.lstm.bias_hh_l{j}"]),
                    }
                    for j in range(cfg.num_lstm_layers)
                ]
            }
    return {"layers": layers}
