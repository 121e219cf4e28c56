"""Plain reference of the wav2vec 2.0 / HuBERT encoder (the w2v2-base and
MERT-v1-95M configurations), one clip at a time at its own length: no
padding, no mask, no batching, no kernel of the program.

From the published architecture (Baevski et al. 2020, "wav2vec 2.0", and
the Hugging Face ``Wav2Vec2Model`` it is released as), with the keys of a
configuration file of ``portbench/configs``:

- optional per-utterance input normalisation, zero mean and unit variance
  over the clip, eps 1e-7 (the feature extractor's ``do_normalize``);
- seven 1-D convolutions (``conv_dim``, ``conv_kernel``, ``conv_stride``),
  GELU after each; ``feat_extract_norm`` "group": a GroupNorm with one
  group per channel after the first, "layer": a LayerNorm over channels
  after each;
- the feature projection: LayerNorm over the conv channels, then a linear
  map to ``hidden_size``;
- the positional convolution (``num_conv_pos_embeddings`` taps in
  ``num_conv_pos_embedding_groups`` groups, padding k // 2, the last frame
  dropped for an even k, GELU) added to its input;
- post-norm layers (LayerNorm of the sum after attention and after the
  feed-forward, the encoder's LayerNorm before the first layer), or pre-norm
  layers and a final LayerNorm with ``do_stable_layer_norm``;
- multi-head attention softmax(q k^T / sqrt(d)) v with biased projections,
  and a GELU feed-forward of width ``intermediate_size``.

Weights come as a dict of tensors under the names the benchmark gives them
(``portbench/families/speech.py``). Everything runs in float32; the caller
sets the TF32 switches (off for the reference, on for its control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], eps)


def _linear(x, w, prefix):
    return x @ w[f"{prefix}.weight"].T + w[f"{prefix}.bias"]


def forward(cfg: dict, w: dict, audio: torch.Tensor, layer: int) -> torch.Tensor:
    """(n,) float32 audio -> (frames, hidden_size) float32: hidden state
    ``layer`` (0 = the input of the first layer)."""
    eps = cfg["layer_norm_eps"]
    x = audio.float()
    if cfg["do_normalize"]:
        mean = x.mean()
        x = (x - mean) / torch.sqrt(((x - mean) ** 2).mean() + 1e-7)
    x = x[None, None, :]
    for i, stride in enumerate(cfg["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}"
        x = F.conv1d(x, w[f"{p}.conv.weight"], w.get(f"{p}.conv.bias"), stride=stride)
        if cfg["feat_extract_norm"] == "group" and i == 0:
            x = F.group_norm(x, x.shape[1], w[f"{p}.layer_norm.weight"],
                             w[f"{p}.layer_norm.bias"], eps=1e-5)
        elif cfg["feat_extract_norm"] == "layer":
            x = _ln(x.transpose(1, 2), w, f"{p}.layer_norm", eps).transpose(1, 2)
        x = F.gelu(x)
    x = x[0].T  # (frames, channels)
    if cfg["feat_proj_layer_norm"]:
        x = _ln(x, w, "feature_projection.layer_norm", eps)
    x = _linear(x, w, "feature_projection.projection")

    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.T[None], w["encoder.pos_conv.weight"], w["encoder.pos_conv.bias"],
                   padding=k // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos[0].T)
    stable = cfg["do_stable_layer_norm"]
    if not stable:
        x = _ln(x, w, "encoder.layer_norm", eps)

    heads = cfg["num_attention_heads"]
    for i in range(layer):
        p = f"encoder.layers.{i}"

        def attention(y):
            t, h = y.shape
            d = h // heads
            q, kk, v = (_linear(y, w, f"{p}.attention.{n}_proj").reshape(t, heads, d).transpose(0, 1)
                        for n in ("q", "k", "v"))
            a = torch.softmax(q @ kk.transpose(1, 2) / d ** 0.5, dim=-1) @ v
            return _linear(a.transpose(0, 1).reshape(t, h), w, f"{p}.attention.out_proj")

        def feed_forward(y):
            y = F.gelu(_linear(y, w, f"{p}.feed_forward.intermediate_dense"))
            return _linear(y, w, f"{p}.feed_forward.output_dense")

        if stable:
            x = x + attention(_ln(x, w, f"{p}.layer_norm", eps))
            x = x + feed_forward(_ln(x, w, f"{p}.final_layer_norm", eps))
        else:
            x = _ln(x + attention(x), w, f"{p}.layer_norm", eps)
            x = _ln(x + feed_forward(x), w, f"{p}.final_layer_norm", eps)
    if stable and layer == cfg["num_hidden_layers"]:
        x = _ln(x, w, "encoder.layer_norm", eps)
    return x
