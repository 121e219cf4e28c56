"""The FLOP counter of ``mfu`` against a count by hand."""

import json
from pathlib import Path

from portbench.flops import conv_frames, speech_clip_flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

TINY = dict(conv_dim=[4, 6], conv_kernel=[4, 2], conv_stride=[2, 2], hidden_size=8,
            intermediate_size=16, num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2)


def test_tiny_geometry_by_hand():
    # 20 samples: conv 1 (k=4, s=2) -> 9 frames, conv 2 (k=2, s=2) -> 4 frames.
    assert conv_frames(TINY, 20) == [9, 4]
    conv = 2 * 9 * 4 * 1 * 4 + 2 * 4 * 6 * 4 * 2  # 288 + 384
    proj = 2 * 4 * 6 * 8  # 384
    pos = 2 * 4 * 8 * (8 // 2) * 4  # 1024
    layer = 4 * (2 * 4 * 8 * 8) + 2 * (2 * 4 * 8 * 16) + 2 * (2 * 4 * 4 * 8)  # 2048 + 2048 + 512
    assert speech_clip_flops(TINY, 20, 0) == conv + proj + pos
    assert speech_clip_flops(TINY, 20, 3) == conv + proj + pos + 3 * layer


def test_w2v2_base_ten_seconds():
    cfg = json.loads((CONFIGS / "w2v2-base.json").read_text())
    assert conv_frames(cfg, 160000)[-1] == 499
    flops = speech_clip_flops(cfg, 160000, 12)
    assert 147e9 < flops < 149e9  # ~148 GFLOP for a 10 s clip


def test_too_short_clip_has_no_frames():
    assert conv_frames(TINY, 3) == [0, 0]
    assert speech_clip_flops(TINY, 3, 2) == 0
