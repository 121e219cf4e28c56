"""Checkpoint -> parameter tree conversion for the speech-transformer family.

The port of ``fadtk_tpu/weights/speech.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

Consumes an HF state_dict (Wav2Vec2Model / HubertModel / WavLMModel / MERT) and
produces the parameter pytree expected by
``fadtk_tpu.models.speech.encoder.speech_encoder_forward``.

Layout rules:
- torch Linear (out, in)            -> kernel (in, out)          [transpose]
- torch Conv1d (out, in/groups, k)  -> kernel (k, in/groups, out) [transpose(2,1,0)]
- torch (Group/Layer)Norm weight/bias -> scale/bias
- weight-normed positional conv is materialized to an effective dense kernel
  (g * v / ||v|| over dims (0, 1), i.e. weight_norm dim=2 as in HF
  Wav2Vec2PositionalConvEmbedding); handles both the legacy ``weight_g/weight_v``
  and the new ``parametrizations.weight.original0/1`` torch naming.
"""

from __future__ import annotations

import numpy as np

from ..models.speech.config import SpeechEncoderConfig


def _t(x) -> np.ndarray:
    """torch tensor -> numpy float32."""
    return np.asarray(x.detach().cpu().numpy(), dtype=np.float32)


def _dense(sd, prefix):
    return {"kernel": _t(sd[f"{prefix}.weight"]).T, "bias": _t(sd[f"{prefix}.bias"])}


def _norm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _conv(sd, prefix, bias: bool):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).transpose(2, 1, 0)}
    if bias:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _pos_conv(sd, prefix):
    """Materialize the weight-normed positional conv kernel."""
    if f"{prefix}.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _t(sd[f"{prefix}.parametrizations.weight.original1"])
    else:
        g = _t(sd[f"{prefix}.weight_g"])
        v = _t(sd[f"{prefix}.weight_v"])
    # weight_norm dim=2: norm over dims (0, 1) per kernel position.
    norm = np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # (out, in/groups, k)
    return {"kernel": w.transpose(2, 1, 0), "bias": _t(sd[f"{prefix}.bias"])}


def convert_speech_encoder(state_dict, cfg: SpeechEncoderConfig):
    """HF state_dict (of the bare *Model, no head) -> our param pytree."""
    sd = state_dict
    # Tolerate checkpoints saved from a CTC/classification wrapper.
    for wrapper in ("wav2vec2.", "hubert.", "wavlm.", "mert."):
        if any(k.startswith(wrapper + "feature_extractor") for k in sd):
            sd = {k[len(wrapper):]: v for k, v in sd.items() if k.startswith(wrapper)}
            break

    conv_layers = []
    for i in range(len(cfg.conv_dim)):
        prefix = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": _conv(sd, f"{prefix}.conv", cfg.conv_bias)}
        if (cfg.feat_extract_norm == "group" and i == 0) or cfg.feat_extract_norm == "layer":
            layer["layer_norm"] = _norm(sd, f"{prefix}.layer_norm")
        conv_layers.append(layer)

    feature_projection = {"projection": _dense(sd, "feature_projection.projection")}
    if cfg.feat_proj_layer_norm:
        feature_projection["layer_norm"] = _norm(sd, "feature_projection.layer_norm")

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        attn = {
            "q_proj": _dense(sd, f"{p}.attention.q_proj"),
            "k_proj": _dense(sd, f"{p}.attention.k_proj"),
            "v_proj": _dense(sd, f"{p}.attention.v_proj"),
            "out_proj": _dense(sd, f"{p}.attention.out_proj"),
        }
        if cfg.attention_type == "wavlm":
            attn["gru_rel_pos_const"] = _t(sd[f"{p}.attention.gru_rel_pos_const"]).reshape(-1)
            attn["gru_rel_pos_linear"] = _dense(sd, f"{p}.attention.gru_rel_pos_linear")
            if i == 0:
                attn["rel_attn_embed"] = _t(sd[f"{p}.attention.rel_attn_embed.weight"])
        layers.append(
            {
                "attention": attn,
                "layer_norm": _norm(sd, f"{p}.layer_norm"),
                "feed_forward": {
                    "intermediate_dense": _dense(sd, f"{p}.feed_forward.intermediate_dense"),
                    "output_dense": _dense(sd, f"{p}.feed_forward.output_dense"),
                },
                "final_layer_norm": _norm(sd, f"{p}.final_layer_norm"),
            }
        )

    return {
        "feature_extractor": {"conv_layers": conv_layers},
        "feature_projection": feature_projection,
        "encoder": {
            "pos_conv": _pos_conv(sd, "encoder.pos_conv_embed.conv"),
            "layer_norm": _norm(sd, "encoder.layer_norm"),
            "layers": layers,
        },
    }
