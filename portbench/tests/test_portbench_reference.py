"""The plain reference against the program on the CPU at a tiny size: the
same seeded weights, one clip, the program's forward on the clip zero-padded
in a bucket with its valid length, the reference on the clip alone."""

import json

import pytest
import torch

from portbench.families import speech
from portbench.reference import speech_encoder
from tiny import REPO, TINY_FIELDS


def tiny_cfg(**kw):
    cfg = json.loads((REPO / "portbench/configs/w2v2-base.json").read_text())
    cfg.update(TINY_FIELDS, **kw)
    return cfg


@pytest.mark.parametrize("normalize", [True, False])
def test_reference_equals_the_program(normalize):
    from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
    from fadtk_tpu_torch.models.speech.encoder import SpeechEncoder, speech_encoder_forward

    cfg = tiny_cfg(do_normalize=normalize)
    w = speech.make_weights(cfg, 2**31 + 3, torch.device("cpu"))
    module = SpeechEncoder(SpeechEncoderConfig(
        conv_dim=tuple(cfg["conv_dim"]), hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        do_normalize=normalize))
    module.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(0)
    n, bucket = 9000, 16000
    clip = 0.3 * torch.randn(n, generator=g)
    audio = torch.zeros(2, bucket)
    audio[0, :n] = clip
    audio[1] = 0.3 * torch.randn(bucket, generator=g)
    with torch.inference_mode():
        states, mask = speech_encoder_forward(module, audio, torch.tensor([n, bucket]), taps=(2,))
        ref = speech_encoder.forward(cfg, w, clip, 2)
    valid = int(mask[0].sum())
    assert valid == ref.shape[0]
    torch.testing.assert_close(states[0, 0, :valid], ref, atol=2e-5, rtol=2e-5)


def test_weights_follow_the_seed_and_fill_every_leaf():
    cfg = tiny_cfg()
    a = speech.make_weights(cfg, 7, torch.device("cpu"))
    b = speech.make_weights(cfg, 7, torch.device("cpu"))
    c = speech.make_weights(cfg, 8, torch.device("cpu"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    assert all(a[k].abs().max() > 0 for k in a)
