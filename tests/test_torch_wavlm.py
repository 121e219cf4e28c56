"""WavLM, HuBERT and MERT in the PyTorch port against fadtk_tpu on the CPU.

A small geometry (3 convs of width 32, hidden 64, 4 heads, 2 layers) with
WavLM's gated relative-position-bias attention. The JAX parameters from
``init_speech_encoder_params(PRNGKey(0))`` are carried into the port with
``params_from_jax``, and the same numpy audio goes through both. HF's
``WavLMModel`` and ``HubertModel`` are a second oracle, loaded through the JAX
package's converter as tests/test_speech_encoder.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.encoder import (
    SpeechEncoder,
    _wavlm_relative_buckets,
    init_speech_encoder,
    speech_encoder_forward,
    use_flash_attention,
    wavlm_attention,
    wavlm_position_bias,
)
from fadtk_tpu_torch.weights.store import params_from_jax

SMALL = dict(
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    attention_type="wavlm", num_buckets=320, max_bucket_distance=800,
)
# wavlm-base(-plus): post-norm + group-norm extractor; wavlm-large: pre-norm +
# layer-norm extractor with conv bias and input normalisation.
VARIANTS = {
    "postnorm": dict(feat_extract_norm="group", do_stable_layer_norm=False,
                     conv_bias=False, do_normalize=False),
    "prenorm": dict(feat_extract_norm="layer", do_stable_layer_norm=True,
                    conv_bias=True, do_normalize=True),
}
# The bounds of tests/test_torch_speech_encoder.py. f32: summation order
# (measured <= 3.5e-6 here). bf16: both round every GEMM/conv output to bf16
# at different points; measured 6.3e-2 (postnorm) and 4.7e-2 (prenorm) on
# hidden states of magnitude ~3.8, about two bf16 ulps there.
ATOL_F32 = 1e-4
ATOL_BF16 = 0.15


def _pair(variant):
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params

    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS[variant])
    params = init_speech_encoder_params(cfg, jax.random.PRNGKey(0))
    model = SpeechEncoder(cfg)
    model.load_state_dict(params_from_jax(params))  # strict: one to one
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


@pytest.mark.parametrize("t", [74, 499, 749])
def test_relative_buckets_bit_equal(t):
    from fadtk_tpu.models.speech.encoder import _wavlm_relative_buckets as jax_buckets

    got = _wavlm_relative_buckets(320, 800, t)
    want = jax_buckets(320, 800, t)
    assert got.dtype == want.dtype == np.int64 and got.shape == (t, t)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < 320


def test_position_bias_matches_jax():
    from fadtk_tpu.models.speech.encoder import wavlm_position_bias as jax_pb

    cfg, params, model = _pair("postnorm")
    table = params["encoder"]["layers"][0]["attention"]["rel_attn_embed"]
    want = jax_pb(cfg, table, 57)
    got = wavlm_position_bias(cfg, model.encoder["layers"][0]["attention"].rel_attn_embed, 57)
    assert got.shape == (cfg.num_heads, 57, 57) and got.is_contiguous()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_params_from_jax_is_one_to_one():
    """Every leaf of the JAX tree lands on one torch parameter, and only
    layer 0 holds the relative-position table."""
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params

    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS["postnorm"])
    state = params_from_jax(init_speech_encoder_params(cfg, jax.random.PRNGKey(0)))
    model = SpeechEncoder(cfg)
    assert set(state) == set(model.state_dict())
    assert [k for k in state if "rel_attn_embed" in k] == [
        "encoder.layers.0.attention.rel_attn_embed"
    ]
    assert state["encoder.layers.1.attention.gru_rel_pos_linear.weight"].shape == (8, 16)
    assert state["encoder.layers.1.attention.gru_rel_pos_const"].shape == (4,)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wavlm_f32_hidden_states_match_jax(variant):
    from fadtk_tpu.models.speech.encoder import speech_encoder_forward as jax_forward

    cfg, params, model = _pair(variant)
    audio, nv = _audio()
    want, want_mask = jax_forward(cfg, params, jnp.asarray(audio), jnp.asarray(nv))
    with torch.no_grad():
        got, got_mask = speech_encoder_forward(model, torch.from_numpy(audio), torch.from_numpy(nv))
    assert got.dtype == torch.float32
    _compare_valid(got.numpy(), got_mask.numpy(), np.asarray(want), np.asarray(want_mask), ATOL_F32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wavlm_bf16_hidden_states_close_to_jax(variant, monkeypatch):
    """bf16 with the flash kernel forced on: the port's CPU call goes to the
    bias twin, JAX's to its Pallas kernel with the bias operands (interpret
    mode on the CPU)."""
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
def test_wavlm_padding_exactness(dtype, monkeypatch):
    """A clip padded into a longer bucket, batched beside other clips, gives
    the valid frames of its unpadded run; the position bias is built for the
    padded length, and the bf16 case routes attention through the bias twin."""
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
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got[:, 0, :n].float().numpy(), ref[:, 0].float().numpy(), atol=atol)
    assert torch.isfinite(got.float()).all()


def test_wavlm_random_init():
    cfg = SpeechEncoderConfig(**SMALL, **VARIANTS["prenorm"])
    m = init_speech_encoder(SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    attn0, attn1 = m.encoder["layers"][0]["attention"], m.encoder["layers"][1]["attention"]
    assert torch.equal(attn1.gru_rel_pos_const, torch.ones(4))
    assert not hasattr(attn1, "rel_attn_embed")
    assert 0.01 < attn0.rel_attn_embed.std().item() < 0.03  # N(0, 1) * 0.02
    with torch.no_grad():
        states, _ = m(torch.from_numpy(_audio()[0]))
    assert torch.isfinite(states).all()


# --------------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------------- #


def _spy(monkeypatch):
    from fadtk_tpu_torch.ops import flash_attention as fa

    calls = []

    def spy(q, k, v, n_valid=None, position_bias=None, gate=None, *, num_heads):
        calls.append((position_bias, gate))
        return fa.flash_attention_packed_reference(q, k, v, n_valid, position_bias, gate,
                                                   num_heads=num_heads)

    monkeypatch.setattr(fa, "flash_attention_packed", spy)
    return calls


def test_wavlm_routing_use_flash_attention(monkeypatch):
    """bf16 on a CUDA tensor takes the kernel; f32 stays plain at every
    length, also with FADTK_TPU_FLASH_F32=1 (WavLM passes no length); CPU
    tensors take the plain path unless the kernel is forced on."""
    monkeypatch.delenv("FADTK_TPU_FLASH_ATTENTION", raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fv = torch.ones(2, dtype=torch.int32)
    assert use_flash_attention(torch.bfloat16, fv, None, cuda)
    assert not use_flash_attention(torch.bfloat16, fv, None, cpu)
    monkeypatch.setenv("FADTK_TPU_FLASH_F32", "1")
    assert use_flash_attention(torch.float32, fv, 749, cuda)  # standard attention opts in
    assert not use_flash_attention(torch.float32, fv, None, cuda)  # WavLM does not


@pytest.mark.parametrize("dtype,flash_env,f32_env,kernel", [
    (torch.bfloat16, "1", "", True),   # the card's default for bf16 (forced here)
    (torch.float32, "1", "1", False),  # f32 stays dense even when opted in, T=749
    (torch.bfloat16, "", "", False),   # CPU default: plain dense path
])
def test_wavlm_attention_routes(dtype, flash_env, f32_env, kernel, monkeypatch):
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", flash_env)
    monkeypatch.setenv("FADTK_TPU_FLASH_F32", f32_env)
    calls = _spy(monkeypatch)
    cfg, _, model = _pair("postnorm")
    model = model.to(dtype)
    p = model.encoder["layers"][0]["attention"]
    b, t = 2, 749
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((b, t, 64)).astype(np.float32))
    x = (0.1 * x).to(dtype)
    fv = torch.tensor([t, 300], dtype=torch.int32)
    frame_mask = (torch.arange(t)[None, :] < fv[:, None]).to(dtype)
    key_bias = (1.0 - frame_mask)[:, None, None, :] * torch.finfo(dtype).min
    with torch.no_grad():
        pb = wavlm_position_bias(cfg, p.rel_attn_embed, t)
        out = wavlm_attention(cfg, p, x, key_bias, pb, fv)
    assert out.shape == x.shape and out.dtype == dtype and torch.isfinite(out.float()).all()
    assert len(calls) == int(kernel)
    if kernel:
        pb32, gate = calls[0]
        assert pb32.dtype == gate.dtype == torch.float32
        assert pb32.shape == (4, t, t) and gate.shape == (b, t, 4) and gate.is_contiguous()
        # the kernel route and the dense route agree on valid rows
        monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "0")
        with torch.no_grad():
            dense = wavlm_attention(cfg, p, x, key_bias, pb, fv)
        for i, n in enumerate(fv.tolist()):
            np.testing.assert_allclose(out[i, :n].float().numpy(), dense[i, :n].float().numpy(),
                                       atol=3e-2, rtol=0)


# --------------------------------------------------------------------------- #
# HF as a second oracle
# --------------------------------------------------------------------------- #


def _hf_compare(hf_model, cfg, audio, atol=2e-4):
    from fadtk_tpu.weights.speech import convert_speech_encoder

    hf_model.eval()
    with torch.no_grad():
        out = hf_model(torch.from_numpy(audio[None]), output_hidden_states=True)
    hf_states = np.stack([h.numpy()[0] for h in out.hidden_states])
    model = SpeechEncoder(cfg)
    model.load_state_dict(params_from_jax(convert_speech_encoder(hf_model.state_dict(), cfg)))
    with torch.no_grad():
        states, mask = speech_encoder_forward(model.eval(), torch.from_numpy(audio[None]))
    ours = states[:, 0].numpy()
    assert hf_states.shape == ours.shape
    np.testing.assert_allclose(ours, hf_states, atol=atol)
    assert bool((mask == 1).all())


_HF_SMALL = dict(
    conv_dim=[32, 32, 32], conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
    num_feat_extract_layers=3, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
    intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
    layerdrop=0.0, mask_time_prob=0.0, mask_feature_prob=0.0, hidden_act="gelu",
    feat_extract_activation="gelu", feat_extract_norm="group", do_stable_layer_norm=False,
    conv_bias=False,
)
_PORT_SMALL = dict(
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
    hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_normalize=False,
    feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
)


def test_hf_wavlm_oracle():
    from transformers import WavLMConfig, WavLMModel

    torch.manual_seed(3)
    hf = WavLMModel(WavLMConfig(**_HF_SMALL, num_buckets=64, max_bucket_distance=160))
    cfg = SpeechEncoderConfig(**_PORT_SMALL, attention_type="wavlm", num_buckets=64,
                              max_bucket_distance=160)
    _hf_compare(hf, cfg, np.random.default_rng(3).standard_normal(4000).astype(np.float32))


def test_hf_hubert_oracle():
    from transformers import HubertConfig, HubertModel

    torch.manual_seed(2)
    hf = HubertModel(HubertConfig(**_HF_SMALL, feat_proj_layer_norm=True))
    cfg = SpeechEncoderConfig(**_PORT_SMALL)
    _hf_compare(hf, cfg, np.random.default_rng(2).standard_normal(4000).astype(np.float32))


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #


def test_registry_parity_with_jax_package():
    """Every hubert, MERT and wavlm variant of the JAX registry is in the
    port, in the same order, with the same fields and configuration."""
    from fadtk_tpu.models.registry import get_all_models as jax_models

    from fadtk_tpu_torch.models.registry import get_all_models, get_model

    prefixes = ("hubert-", "MERT-", "wavlm-", "w2v2-")
    want = [m for m in jax_models() if m.name.startswith(prefixes)]
    got = [m for m in get_all_models() if m.name.startswith(prefixes)]
    assert [m.name for m in got] == [m.name for m in want]
    assert sum(m.name.startswith(("hubert-", "MERT-", "wavlm-")) for m in got) == 96
    for g, w in zip(got, want):
        assert (g.name, g.sr, g.num_features, g.layer, g.hf_source, g.limit) == (
            w.name, w.sr, w.num_features, w.layer, w.hf_source, w.limit)
        assert g.cfg.__dict__ == w.cfg.__dict__, g.name
        assert type(g).__name__ == type(w).__name__
    mert = get_model("MERT-v1-95M")
    assert mert.sr == 24000 and mert.cfg.num_output_frames(10 * 24000) == 749
