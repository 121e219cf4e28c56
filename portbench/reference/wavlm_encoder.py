"""Plain reference of the WavLM encoder (the wavlm-large configuration), one
clip at a time at its own length: no padding, no mask, no batching, no
kernel of the program.

From the published architecture (Chen et al. 2021, "WavLM: Large-Scale
Self-Supervised Pre-Training for Full Stack Speech Processing",
arXiv:2110.13900, and the Hugging Face ``WavLMModel`` it is released as),
with the keys of a configuration file of ``portbench/configs``:

- everything up to the first layer as in ``speech_encoder.py`` (input
  normalisation, the conv extractor, the feature projection, the
  positional convolution);
- pre-norm layers (``do_stable_layer_norm``): x + attention(LN(x)), then
  x + feed-forward(LN(x)); the encoder's LayerNorm after the last layer,
  or post-norm layers as in ``speech_encoder.py``;
- attention softmax(q k^T / sqrt(d) + g_h(t) B_h[t, s]) v per head h,
  query t and key s. B_h is layer 0's table ``rel_attn_embed``
  (``num_buckets`` x heads) looked up at the T5 bucket of s - t, and every
  layer reads it. The gate g_h(t) = a (b c_h - 1) + 2, with (a, b) the
  sigmoid of the head's slice of the attention's *input* through
  ``gru_rel_pos_linear`` (head_dim -> 8), summed in two groups of 4, and
  c_h the layer's ``gru_rel_pos_const``.

One departure from Hugging Face: the bucket's logarithm is taken in
float64, as the program does, where ``WavLMAttention._relative_positions_
bucket`` takes it in float32; the two could part only where the scaled
logarithm lies within float32 rounding of a whole number.

Weights come as a dict of tensors under the names the benchmark gives them
(``portbench/families/wavlm.py``). Everything runs in float32; the caller
sets the TF32 switches (off for the reference, on for its control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .speech_encoder import _linear, _ln
from .speech_encoder import forward as encoder_input


def relative_buckets(num_buckets: int, max_distance: int, t: int) -> torch.Tensor:
    """(T, T) int64: the T5 bucket of key s - query t. Half the buckets for
    keys after the query; in each half, distances below a quarter of the
    buckets exactly, then logarithmically spaced up to ``max_distance``,
    the last bucket beyond."""
    half = num_buckets // 2
    exact = half // 2
    rel = torch.arange(t)[None, :] - torch.arange(t)[:, None]
    after = (rel > 0).to(torch.int64) * half
    dist = rel.abs()
    log = torch.log(dist.clamp(min=1).to(torch.float64) / exact) / math.log(max_distance / exact)
    far = (exact + (log * (half - exact)).to(torch.int64)).clamp(max=half - 1)
    return after + torch.where(dist < exact, dist, far)


def forward(cfg: dict, w: dict, audio: torch.Tensor, layer: int) -> torch.Tensor:
    """(n,) float32 audio -> (frames, hidden_size) float32: hidden state
    ``layer`` (0 = the input of the first layer)."""
    eps = cfg["layer_norm_eps"]
    x = encoder_input(cfg, w, audio, 0)
    t, h = x.shape
    heads = cfg["num_attention_heads"]
    d = h // heads
    buckets = relative_buckets(cfg["num_buckets"], cfg["max_bucket_distance"], t).to(x.device)
    table = w["encoder.layers.0.attention.rel_attn_embed"]
    position_bias = table[buckets].permute(2, 0, 1)  # (heads, T, T)
    stable = cfg["do_stable_layer_norm"]

    for i in range(layer):
        p = f"encoder.layers.{i}"

        def attention(y):
            g = _linear(y.reshape(t, heads, d), w, f"{p}.attention.gru_rel_pos_linear")
            a, b = torch.sigmoid(g.reshape(t, heads, 2, 4).sum(-1)).unbind(-1)  # (T, heads)
            gate = a * (b * w[f"{p}.attention.gru_rel_pos_const"] - 1.0) + 2.0
            q, k, v = (_linear(y, w, f"{p}.attention.{n}_proj").reshape(t, heads, d).transpose(0, 1)
                       for n in ("q", "k", "v"))
            logits = q @ k.transpose(1, 2) / d ** 0.5 + gate.T[:, :, None] * position_bias
            o = torch.softmax(logits, dim=-1) @ v
            return _linear(o.transpose(0, 1).reshape(t, h), w, f"{p}.attention.out_proj")

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
