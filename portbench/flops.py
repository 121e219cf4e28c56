"""Model FLOPs of the speech encoder for one clip at its own valid length:
what ``mfu`` counts. Frozen with the benchmark.

A multiply-add counts 2 FLOP; elementwise work (norms, GELU, softmax,
residual sums) is left out. Counted: the seven extractor convolutions, the
feature projection, the positional convolution, the q/k/v/out projections,
the feed-forward, and q k^T and p v over the valid frames only, for the
layers up to the tapped one.
"""

from __future__ import annotations


def conv_frames(cfg: dict, samples: int) -> list[int]:
    """Output frames of each extractor convolution for a clip of ``samples``."""
    out, n = [], samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = max((n - k) // s + 1, 0)
        out.append(n)
    return out


def speech_clip_flops(cfg: dict, samples: int, layer: int) -> int:
    frames = conv_frames(cfg, samples)
    t = frames[-1]
    flops, c_in = 0, 1
    for n_out, c_out, k in zip(frames, cfg["conv_dim"], cfg["conv_kernel"]):
        flops += 2 * n_out * c_out * c_in * k
        c_in = c_out
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    flops += 2 * t * cfg["conv_dim"][-1] * h  # feature projection
    flops += 2 * t * h * (h // cfg["num_conv_pos_embedding_groups"]) * cfg["num_conv_pos_embeddings"]
    per_layer = 2 * t * h * h * 4 + 2 * t * h * f * 2 + 2 * t * t * h * 2
    return flops + layer * per_layer
