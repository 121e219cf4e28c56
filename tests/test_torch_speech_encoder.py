"""Speech encoder of the PyTorch port against fadtk_tpu on the CPU.

A small geometry (3 convs of width 32, hidden 64, 4 heads, 2 layers). The JAX
parameters from ``init_speech_encoder_params(PRNGKey(0))`` are carried into
the port with ``params_from_jax``, and the same numpy audio goes through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.encoder import (
    SpeechEncoder,
    init_speech_encoder,
    speech_encoder_forward,
    use_flash_attention,
)
from fadtk_tpu_torch.weights.store import params_from_jax

SMALL = dict(
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
)
# post-norm + group-norm extractor (w2v2-base) and pre-norm + layer-norm
# extractor with conv bias and input normalisation (the "stable" large form).
VARIANTS = {
    "postnorm": dict(feat_extract_norm="group", do_stable_layer_norm=False,
                     conv_bias=False, do_normalize=False),
    "prenorm": dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                    conv_bias=True, do_normalize=True),
}
# f32: the two frameworks' convolutions and GEMMs sum in different orders;
# measured <= 3e-6 on these inputs.
ATOL_F32 = 1e-4
# bf16: both round every GEMM/conv output to bf16 but at different points
# (torch's CPU kernels round once per fused op, XLA per op); measured max
# 6.3e-2 (postnorm) and 4.7e-2 (prenorm) on hidden states of magnitude ~4,
# i.e. about two bf16 ulps there.
ATOL_BF16 = 0.15


def _pair(variant):
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params

    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS[variant])
    params = init_speech_encoder_params(cfg, jax.random.PRNGKey(0))
    model = SpeechEncoder(cfg)
    model.load_state_dict(params_from_jax(params))
    return cfg, params, model.eval()


def _audio():
    rng = np.random.default_rng(0)
    audio = (0.3 * rng.standard_normal((3, 8000))).astype(np.float32)
    return audio, np.array([8000, 5000, 1], np.int32)


def _compare_valid(got, got_mask, want, want_mask, atol):
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got.shape == want.shape
    for b in range(got.shape[1]):
        n = int(want_mask[b].sum())
        np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_f32_hidden_states_match_jax(variant):
    from fadtk_tpu.models.speech.encoder import speech_encoder_forward as jax_forward

    cfg, params, model = _pair(variant)
    audio, nv = _audio()
    want, want_mask = jax_forward(cfg, params, jnp.asarray(audio), jnp.asarray(nv))
    with torch.no_grad():
        got, got_mask = speech_encoder_forward(model, torch.from_numpy(audio), torch.from_numpy(nv))
    assert got.dtype == torch.float32
    _compare_valid(got.numpy(), got_mask.numpy(), np.asarray(want), np.asarray(want_mask), ATOL_F32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_hidden_states_close_to_jax(variant, monkeypatch):
    """bf16 mode: same precision policy (tanh GELU, one-pass GroupNorm with
    f32 sums, f32 LayerNorm statistics, f32 logits and softmax). With the
    flash kernel forced on, the port's CPU call goes to its plain twin and
    JAX's to its Pallas kernel, which runs in interpret mode on the CPU."""
    from fadtk_tpu.models.precision import cast_params_bf16
    from fadtk_tpu.models.speech.encoder import speech_encoder_forward as jax_forward

    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "1")
    cfg, params, model = _pair(variant)
    model = model.to(torch.bfloat16)
    audio, nv = _audio()
    want, want_mask = jax_forward(cfg, cast_params_bf16(params), jnp.asarray(audio), jnp.asarray(nv))
    with torch.no_grad():
        got, got_mask = speech_encoder_forward(model, torch.from_numpy(audio), torch.from_numpy(nv))
    assert got.dtype == torch.bfloat16
    _compare_valid(got.float().numpy(), got_mask.float().numpy(),
                   np.asarray(want, np.float32), np.asarray(want_mask, np.float32), ATOL_BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_exactness(dtype, monkeypatch):
    """A clip padded into a longer bucket, batched beside other clips, gives
    the valid frames of its unpadded run (the bf16 case routes attention
    through the flash twin, with fully padded rows)."""
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "1")
    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS["postnorm"])
    model = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    model = model.to(dtype).eval()
    audio = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal(3000)).astype(np.float32))
    padded = torch.zeros((2, 16384))
    padded[0, :3000] = audio
    padded[1] = torch.from_numpy(np.random.default_rng(5).standard_normal(16384).astype(np.float32))
    with torch.no_grad():
        ref, _ = speech_encoder_forward(model, audio[None], torch.tensor([3000]))
        got, mask = speech_encoder_forward(model, padded, torch.tensor([3000, 1]))
    n = int(mask[0].sum())
    assert n == ref.shape[2] == cfg.num_output_frames(3000)
    assert int(mask[1].sum()) == 0
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got[:, 0, :n].float().numpy(), ref[:, 0].float().numpy(), atol=atol)
    assert torch.isfinite(got.float()).all()


def test_taps_and_random_init():
    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS["postnorm"])
    a = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(0)).eval()
    b = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(0)).eval()
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    audio = torch.from_numpy(_audio()[0])
    with torch.no_grad():
        all_states, _ = a(audio)
        one, _ = a(audio, taps=(1,))
    assert all_states.shape[0] == cfg.num_layers + 1
    torch.testing.assert_close(one[0], all_states[1], rtol=0, atol=0)
    assert torch.isfinite(all_states).all()


def test_attention_routing():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fv = torch.ones(2, dtype=torch.int32)
    assert use_flash_attention(torch.bfloat16, fv, 499, cuda)
    assert not use_flash_attention(torch.float32, fv, 499, cuda)  # f32 parity path
    assert not use_flash_attention(torch.bfloat16, fv, 499, cpu)
    assert not use_flash_attention(torch.bfloat16, None, 499, cuda)


def test_f32_flash_opt_in(monkeypatch):
    cuda = torch.device("cuda")
    fv = torch.ones(2, dtype=torch.int32)
    monkeypatch.setenv("FADTK_TPU_FLASH_F32", "1")
    assert use_flash_attention(torch.float32, fv, 749, cuda)
    assert not use_flash_attention(torch.float32, fv, 499, cuda)  # below T=640
    monkeypatch.setenv("FADTK_TPU_FLASH_F32", "0")
    assert not use_flash_attention(torch.float32, fv, 749, cuda)
