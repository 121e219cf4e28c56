"""Checkpoint -> parameter tree conversion for the DAC 44 kHz encoder.

The port of ``fadtk_tpu/weights/dac.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

Checkpoint tree (descript-audio-codec DAC.state_dict()):
    encoder.block.0                WNConv1d(1, 64, 7)
    encoder.block.{1..4}           EncoderBlock:
        .block.{0,1,2}             ResidualUnit: .block.{0,2}=Snake1d(alpha),
                                   .block.{1,3}=WNConv1d
        .block.3                   Snake1d
        .block.4                   WNConv1d (downsample)
    encoder.block.5                Snake1d
    encoder.block.6                WNConv1d(1024, latent, 3)
Weight norm (dim=0) is materialized; Snake alphas (1, C, 1) flatten to (C,).
"""

from __future__ import annotations

import numpy as np

from ..models.dac_impl import DACEncoderConfig


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _wnconv(sd, prefix):
    if f"{prefix}.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _t(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        g = _t(sd[f"{prefix}.weight_g"])
        v = _t(sd[f"{prefix}.weight_v"])
    norm = np.sqrt(np.sum(v * v, axis=(1, 2), keepdims=True))
    return {"kernel": g * v / np.maximum(norm, 1e-12), "bias": _t(sd[f"{prefix}.bias"])}


def _alpha(sd, prefix):
    return _t(sd[f"{prefix}.alpha"]).reshape(-1)


def convert_dac_encoder(state_dict, cfg: DACEncoderConfig) -> dict:
    sd = dict(state_dict)

    def res_unit(prefix):
        return {
            "alpha1": _alpha(sd, f"{prefix}.block.0"),
            "conv1": _wnconv(sd, f"{prefix}.block.1"),
            "alpha2": _alpha(sd, f"{prefix}.block.2"),
            "conv2": _wnconv(sd, f"{prefix}.block.3"),
        }

    blocks = []
    for i in range(len(cfg.strides)):
        prefix = f"encoder.block.{i + 1}"
        blocks.append(
            {
                "res": [res_unit(f"{prefix}.block.{j}") for j in range(3)],
                "alpha": _alpha(sd, f"{prefix}.block.3"),
                "down": _wnconv(sd, f"{prefix}.block.4"),
            }
        )

    n = len(cfg.strides)
    return {
        "conv_in": _wnconv(sd, "encoder.block.0"),
        "blocks": blocks,
        "alpha_out": _alpha(sd, f"encoder.block.{n + 1}"),
        "conv_out": _wnconv(sd, f"encoder.block.{n + 2}"),
    }
