"""The port's Whisper (``fadtk_tpu_torch.models.whisper*``) against fadtk_tpu
and HF on the CPU.

The JAX package's random parameters (``init_whisper_params(cfg,
PRNGKey(0))``) are carried into the port with ``params_from_jax`` (strict:
one to one), and the same numpy features go through both forwards, at the
JAX test's TINY config (tests/test_whisper.py: d=32, 2+2 layers of 4
heads). HF ``WhisperModel`` with identical weights is the second oracle,
called as the reference calls it (two forced start tokens). The model class
is checked at full width (whisper-tiny, random weights): the 2-frame quirk,
float16 output, ``embed_batch`` against ``get_embedding``, stored
``__config__`` meta, and the registry against the JAX package's.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models import whisper_impl as wi
from fadtk_tpu_torch.weights.store import params_from_jax

TINY = dict(
    d_model=32, encoder_layers=2, encoder_heads=4, decoder_layers=2,
    decoder_heads=4, encoder_ffn=64, decoder_ffn=64, num_mel_bins=80,
    max_source_positions=1500, max_target_positions=448, vocab_size=1000,
    decoder_start_token_id=7,
)
# f32: summation order only (measured <= 1e-6 on values up to ~4).
F32_ATOL = 1e-4
# bf16: torch's CPU kernels and XLA round the bf16 products, softmax and
# GELU at other points, and the port keeps LayerNorm statistics in float32
# where the JAX package takes them in bf16; about two bf16 ulps at |x| ~ 4.
BF16_ATOL = 0.15


def _features(seed=1, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 80, 3000)).astype(np.float32) * 0.5


def _pair(cfg_kwargs, dtype="float32"):
    """(JAX config, JAX params, port model) with the same random weights."""
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.whisper_impl import WhisperConfig, init_whisper_params

    jcfg = WhisperConfig(**cfg_kwargs)
    params = init_whisper_params(jcfg, jax.random.PRNGKey(0), getattr(jnp, dtype))
    model = wi.Whisper(wi.WhisperConfig(**cfg_kwargs))
    model.load_state_dict(params_from_jax(params))  # strict: one to one
    return jcfg, params, model.eval().to(getattr(torch, dtype))


def test_f32_forward_matches_jax():
    import jax.numpy as jnp

    from fadtk_tpu.models.whisper_impl import whisper_forward

    jcfg, params, model = _pair(TINY)
    feats = _features()
    want = np.asarray(whisper_forward(jcfg, params, jnp.asarray(feats)))
    with torch.no_grad():
        got = wi.whisper_forward(model, torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def test_encoder_states_match_jax():
    import jax.numpy as jnp

    from fadtk_tpu.models.whisper_impl import whisper_encode

    jcfg, params, model = _pair(TINY)
    feats = _features(seed=3, b=1)
    want = np.asarray(whisper_encode(jcfg, params, jnp.asarray(feats)))
    with torch.no_grad():
        got = wi.whisper_encode(model, torch.from_numpy(feats))
    assert got.shape == want.shape == (1, 1500, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def test_bf16_forward_close_to_jax():
    import jax.numpy as jnp

    from fadtk_tpu.models.whisper_impl import whisper_forward

    jcfg, params, model = _pair(TINY, "bfloat16")
    feats = _features(seed=4)
    want = np.asarray(whisper_forward(jcfg, params, jnp.asarray(feats)))
    with torch.no_grad():
        got = wi.whisper_forward(model, torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL)


def test_forward_matches_hf_model():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperModel as HFModel

    from fadtk_tpu.weights.whisper import convert_whisper

    torch.manual_seed(0)
    hf = HFModel(HFConfig(
        d_model=32, encoder_layers=2, encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
        num_mel_bins=80, max_source_positions=1500, max_target_positions=448,
        vocab_size=1000, decoder_start_token_id=7, pad_token_id=0, bos_token_id=0,
        eos_token_id=0, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    )).eval()
    cfg = wi.WhisperConfig(**TINY)
    feats = torch.from_numpy(_features(seed=5, b=1))
    with torch.no_grad():
        ref = hf(feats, decoder_input_ids=torch.tensor([[7, 7]])).last_hidden_state
        model = wi.Whisper(cfg)
        model.load_state_dict(params_from_jax(convert_whisper(hf.state_dict(), cfg)))
        got = wi.whisper_forward(model.eval(), feats)
    assert got.shape == ref.shape == (1, 2, 32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


def test_init_scheme_matches_jax_statistics():
    """Same shapes as the JAX init, sinusoidal positions bit-equal, k_proj
    without bias, LayerNorms at 1/0."""
    from fadtk_tpu.models.whisper_impl import _sinusoids

    model = wi.init_whisper_params(wi.Whisper(wi.WhisperConfig(**TINY)),
                                   torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(model.encoder.embed_positions.detach().numpy(),
                                  _sinusoids(1500, 32))
    attn = model.encoder.layers[0]["self_attn"]
    assert attn.k_proj.bias is None and attn.q_proj.bias is not None
    assert float(attn.q_proj.weight.detach().abs().max()) <= 32 ** -0.5
    assert torch.equal(model.decoder.layer_norm.weight, torch.ones(32))
    jcfg, params, _ = _pair(TINY)
    assert set(params_from_jax(params)) == set(model.state_dict())


# --------------------------------------------------------------------------- #
# The model class (full width, random weights)
# --------------------------------------------------------------------------- #


@pytest.fixture
def tiny_model(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    from fadtk_tpu_torch.models.registry import get_model

    model = get_model("whisper-tiny")
    model.ensure_loaded()
    return model


def test_embed_path_two_frames(tiny_model):
    emb = tiny_model.get_embedding(np.random.default_rng(2).standard_normal(16000 * 5) * 0.2)
    assert emb.shape == (2, 384) and emb.dtype == np.float16
    assert np.isfinite(emb).all()


def test_embed_batch_matches_get_embedding(tiny_model):
    rng = np.random.default_rng(11)
    clips = [rng.standard_normal(n) * 0.2 for n in (16000 * 3, 16000 * 7, 16000 * 31)]
    batched = tiny_model.embed_batch(list(clips))
    for clip, got in zip(clips, batched, strict=True):
        want = tiny_model.get_embedding(clip)
        assert got.shape == want.shape == (2, 384) and got.dtype == np.float16
        # batched CPU GEMMs may differ from B=1 by float32 ulps before the
        # float16 storage cast (tests/test_whisper.py's bound)
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=2e-3)


def test_stored_config_meta_is_honoured(monkeypatch, tmp_path):
    """A converted checkpoint's ``__config__`` overrides the size's defaults."""
    import dataclasses
    import json

    from fadtk_tpu.weights.store import save_params

    cfg = wi.WhisperConfig(**TINY)
    jcfg, params, _ = _pair(TINY)
    blob = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    save_params({**params, "__config__": blob}, tmp_path / "openai__whisper-tiny.npz")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    from fadtk_tpu_torch.models.registry import get_model

    model = get_model("whisper-tiny")
    model.ensure_loaded()
    assert model.cfg == cfg and model.module.encoder.conv1.weight.shape == (32, 80, 3)


def test_registry_parity_with_jax_package():
    """vggish and the five whisper sizes: names, rates, widths, configs and
    checkpoint names as in the JAX registry."""
    from fadtk_tpu.models.registry import get_all_models as jax_models

    from fadtk_tpu_torch.models.registry import get_all_models, get_model

    prefixes = ("whisper-", "vggish")
    want = [m for m in jax_models() if m.name.startswith(prefixes)]
    got = [m for m in get_all_models() if m.name.startswith(prefixes)]
    assert [m.name for m in got] == [m.name for m in want] == [
        "vggish", "whisper-tiny", "whisper-small", "whisper-base", "whisper-medium",
        "whisper-large"]
    for g, w in zip(got, want, strict=True):
        assert (g.name, g.sr, g.num_features, g.min_len, type(g).__name__) == (
            w.name, w.sr, w.num_features, w.min_len, type(w).__name__)
        if g.name.startswith("whisper-"):
            assert g.cfg.__dict__ == w.cfg.__dict__ and g.weights_name() == w.weights_name()
    assert get_model("whisper-large").cfg.d_model == 1280
