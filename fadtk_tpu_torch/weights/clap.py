"""Checkpoint -> parameter tree conversion for CLAP's HTSAT audio tower + projection.

The port of ``fadtk_tpu/weights/clap.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

Accepts either key style:
- HF transformers ClapModel (audio_model.audio_encoder.*, audio_projection.*);
- original laion_clap checkpoints (the reference's .pt files,
  fadtk/model_loader.py:300-310): [module.]audio_branch.* with fused qkv and
  Sequential audio_projection.{0,2}.
"""

from __future__ import annotations

import numpy as np

from ..models.htsat import HTSATConfig


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float32)


def _dense(sd, prefix, bias=True):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if bias:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _norm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _is_laion_style(sd) -> bool:
    return any("audio_branch." in k for k in sd)


def _strip_laion(sd) -> dict:
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k.startswith("audio_branch."):
            out[k.removeprefix("audio_branch.")] = v
        elif k.startswith("audio_projection."):
            out[k] = v
    return out


def convert_clap_audio(state_dict, cfg: HTSATConfig) -> dict:
    sd = dict(state_dict)
    laion = _is_laion_style(sd)
    if laion:
        sd = _strip_laion(sd)
        bn_prefix, enc = "bn0", ""
    else:
        enc = "audio_model.audio_encoder."
        bn_prefix = f"{enc}batch_norm"

    params: dict = {
        "batch_norm": {
            "mean": _t(sd[f"{bn_prefix}.running_mean"]),
            "var": _t(sd[f"{bn_prefix}.running_var"]),
            "scale": _t(sd[f"{bn_prefix}.weight"]),
            "bias": _t(sd[f"{bn_prefix}.bias"]),
        },
        "patch_embed": {
            "proj": {
                "kernel": _t(sd[f"{enc}patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
                "bias": _t(sd[f"{enc}patch_embed.proj.bias"]),
            },
            "norm": _norm(sd, f"{enc}patch_embed.norm"),
        },
        "norm": _norm(sd, f"{enc}norm"),
        "stages": [],
    }

    for i, depth in enumerate(cfg.depths):
        blocks = []
        for j in range(depth):
            p = f"{enc}layers.{i}.blocks.{j}"
            if laion:
                # Original HTSAT: fused qkv + norm1/norm2/mlp naming.
                qkv_w = _t(sd[f"{p}.attn.qkv.weight"])
                qkv_b = _t(sd[f"{p}.attn.qkv.bias"])
                d = qkv_w.shape[1]
                attn = {
                    "query": {"kernel": qkv_w[:d].T, "bias": qkv_b[:d]},
                    "key": {"kernel": qkv_w[d : 2 * d].T, "bias": qkv_b[d : 2 * d]},
                    "value": {"kernel": qkv_w[2 * d :].T, "bias": qkv_b[2 * d :]},
                    "output": _dense(sd, f"{p}.attn.proj"),
                    "relative_position_bias_table": _t(
                        sd[f"{p}.attn.relative_position_bias_table"]
                    ),
                }
                blocks.append(
                    {
                        "layernorm_before": _norm(sd, f"{p}.norm1"),
                        "attention": attn,
                        "layernorm_after": _norm(sd, f"{p}.norm2"),
                        "intermediate": _dense(sd, f"{p}.mlp.fc1"),
                        "mlp_output": _dense(sd, f"{p}.mlp.fc2"),
                    }
                )
            else:
                attn = {
                    "query": _dense(sd, f"{p}.attention.self.query"),
                    "key": _dense(sd, f"{p}.attention.self.key"),
                    "value": _dense(sd, f"{p}.attention.self.value"),
                    "output": _dense(sd, f"{p}.attention.output.dense"),
                    "relative_position_bias_table": _t(
                        sd[f"{p}.attention.self.relative_position_bias_table"]
                    ),
                }
                blocks.append(
                    {
                        "layernorm_before": _norm(sd, f"{p}.layernorm_before"),
                        "attention": attn,
                        "layernorm_after": _norm(sd, f"{p}.layernorm_after"),
                        "intermediate": _dense(sd, f"{p}.intermediate.dense"),
                        "mlp_output": _dense(sd, f"{p}.output.dense"),
                    }
                )
        stage: dict = {"blocks": blocks}
        if i < len(cfg.depths) - 1:
            dprefix = f"{enc}layers.{i}.downsample"
            stage["downsample"] = {
                "norm": _norm(sd, f"{dprefix}.norm"),
                "reduction": _dense(sd, f"{dprefix}.reduction", bias=False),
            }
        params["stages"].append(stage)

    # Projection head.
    if laion:
        if "audio_projection.0.weight" in sd:
            params["audio_projection"] = {
                "linear1": _dense(sd, "audio_projection.0"),
                "linear2": _dense(sd, "audio_projection.2"),
            }
    elif "audio_projection.linear1.weight" in state_dict:
        params["audio_projection"] = {
            "linear1": _dense(state_dict, "audio_projection.linear1"),
            "linear2": _dense(state_dict, "audio_projection.linear2"),
        }
    return params


def convert_msclap_audio(state_dict, cfg: HTSATConfig) -> dict:
    """msclap CLAP checkpoint (CLAP_weights_2023.pth; reference
    fadtk/model_loader.py:471-484) -> HTSAT params + msclap projection head.

    msclap tree: audio_encoder.base.htsat.<original HTSAT naming> and
    audio_encoder.projection.{linear1,linear2,layer_norm}.
    """
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    htsat_sd = {
        "audio_branch." + k.removeprefix("audio_encoder.base.htsat."): v
        for k, v in sd.items()
        if k.startswith("audio_encoder.base.htsat.")
    }
    params = convert_clap_audio(htsat_sd, cfg)
    # msclap's Projection declares nn.Linear(..., bias=False) on both linears
    # (msclap/models/clap.py) — only the layer_norm carries a bias.
    params["projection"] = {
        "linear1": _dense(sd, "audio_encoder.projection.linear1", bias=False),
        "linear2": _dense(sd, "audio_encoder.projection.linear2", bias=False),
        "layer_norm": _norm(sd, "audio_encoder.projection.layer_norm"),
    }
    return params
