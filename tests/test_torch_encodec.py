"""EnCodec 24k/48k in the PyTorch port against fadtk_tpu on the CPU.

The JAX parameters from ``init_encodec_params(cfg, PRNGKey(0))`` (full width:
32 filters, ratios 8/5/4/2, a 2-layer LSTM of 512) are carried into the port
with ``params_from_jax(tree, conv_layout="OIH")``, and the same numpy audio
goes through both. HF's ``EncodecEncoder`` is a second oracle, loaded through
the JAX package's converter as tests/test_encodec.py does. The model classes
are checked for frame counts, segmenting, channel handling, the 3-minute cut
and batching.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models import encodec_impl as enc
from fadtk_tpu_torch.weights.store import params_from_jax

T_TEST = 7456  # deliberately not a multiple of the 320x hop
# float32: summation order only (measured <= 1.2e-6 of max|latent|, 24k and
# 48k). bf16: both round every conv output and the LSTM state to bf16 at
# different points (measured in the test's docstring below).
RTOL_F32 = 1e-5


@pytest.fixture(scope="module")
def pairs():
    """{variant: (jax cfg, jax params, port module)} at full width."""
    from fadtk_tpu.models import encodec_impl as jenc

    out = {}
    for variant, jcfg in (("24k", jenc.CONFIG_24K), ("48k", jenc.CONFIG_48K)):
        params = jenc.init_encodec_params(jcfg, jax.random.PRNGKey(0))
        model = enc.EncodecEncoder(enc.CONFIG_24K if variant == "24k" else enc.CONFIG_48K)
        model.load_state_dict(params_from_jax(params, conv_layout="OIH"))  # strict
        out[variant] = (jcfg, params, model.eval())
    return out


def _audio(channels, t=T_TEST, seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, channels, t)) * 0.3).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("variant", ["24k", "48k"])
def test_f32_latents_match_jax(pairs, variant, fused, monkeypatch):
    """With the knob on, the 24k blocks go through the fused wrapper's CPU
    twin (the 48k config never does)."""
    from fadtk_tpu.models.encodec_impl import encodec_encode as jax_encode

    monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", "0")
    jcfg, params, model = pairs[variant]
    audio = _audio(jcfg.audio_channels)
    want = np.asarray(jax_encode(jcfg, params, jnp.asarray(audio)))
    monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", fused)
    with torch.no_grad():
        got = enc.encodec_encode(model, torch.from_numpy(audio))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, -(-T_TEST // 320), 128)
    assert _rel(got.numpy(), want) <= RTOL_F32


@pytest.mark.parametrize("variant", ["24k", "48k"])
def test_bf16_latents_close_to_jax(pairs, variant):
    """bf16 weights and compute in both. Measured max abs diff / max|latent|:
    4.2e-3 (24k) and 8.0e-3 (48k), against 9.0e-3 and 1.2e-2 between JAX's
    own bf16 and f32 latents; bound 5e-2, a few bf16 ulps (2^-8 = 3.9e-3)."""
    import copy

    from fadtk_tpu.models.encodec_impl import encodec_encode as jax_encode
    from fadtk_tpu.models.precision import cast_params_bf16

    jcfg, params, model = pairs[variant]
    audio = _audio(jcfg.audio_channels, seed=1)
    want = np.asarray(jax_encode(jcfg, cast_params_bf16(params), jnp.asarray(audio)))
    with torch.no_grad():
        got = enc.encodec_encode(copy.deepcopy(model).to(torch.bfloat16), torch.from_numpy(audio))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) <= 5e-2


@pytest.mark.parametrize("length", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("pads", [(6, 0), (3, 3), (0, 7), (2, 1)])
def test_reflect_small_input_guard_bit_equal(length, pads):
    from fadtk_tpu.models.encodec_impl import _pad1d as jax_pad1d

    x = np.random.default_rng(length).standard_normal((1, 2, length)).astype(np.float32)
    want = np.asarray(jax_pad1d(jnp.asarray(x), *pads, "reflect"))
    got = enc._pad1d(torch.from_numpy(x), *pads, "reflect").numpy()
    assert got.shape == want.shape == (1, 2, length + sum(pads))
    np.testing.assert_array_equal(got, want)


def test_tiny_input_forward_matches_jax(pairs):
    """A 48k input shorter than the first conv's padding runs through the
    guard in every layer."""
    from fadtk_tpu.models.encodec_impl import encodec_encode as jax_encode

    jcfg, params, model = pairs["48k"]
    audio = _audio(2, t=5, seed=2, b=1)
    want = np.asarray(jax_encode(jcfg, params, jnp.asarray(audio)))
    with torch.no_grad():
        got = enc.encodec_encode(model, torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (1, 1, 128)
    assert _rel(got, want) <= RTOL_F32


# --------------------------------------------------------------------------- #
# HF as a second oracle
# --------------------------------------------------------------------------- #


def _hf_encodec(cfg, seed):
    from transformers.models.encodec.configuration_encodec import EncodecConfig
    from transformers.models.encodec.modeling_encodec import EncodecEncoder

    torch.manual_seed(seed)
    fields = dict(cfg.__dict__, upsampling_ratios=list(cfg.upsampling_ratios))
    encoder = EncodecEncoder(EncodecConfig(**fields)).eval()
    return encoder, {f"encoder.{k}": v for k, v in encoder.state_dict().items()}


@pytest.mark.parametrize("variant", ["24k", "48k"])
def test_hf_encodec_oracle(variant):
    from fadtk_tpu.models.encodec_impl import CONFIG_24K, CONFIG_48K
    from fadtk_tpu.weights.encodec import convert_encodec_encoder

    jcfg = CONFIG_24K if variant == "24k" else CONFIG_48K
    hf, sd = _hf_encodec(jcfg, seed=0)
    audio = _audio(jcfg.audio_channels, t=3200, seed=3)
    with torch.no_grad():
        ref = hf(torch.from_numpy(audio)).numpy().transpose(0, 2, 1)
    model = enc.EncodecEncoder(enc.EncodecEncoderConfig(**jcfg.__dict__))
    model.load_state_dict(params_from_jax(convert_encodec_encoder(sd, jcfg), conv_layout="OIH"))
    with torch.no_grad():
        got = enc.encodec_encode(model.eval(), torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-4)  # tests/test_encodec.py's bound


# --------------------------------------------------------------------------- #
# Weight carry
# --------------------------------------------------------------------------- #


def test_codec_weights_carry_without_transpose(pairs):
    _, params, model = pairs["24k"]
    state = params_from_jax(params, conv_layout="OIH")
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(state["layers.0.weight"].numpy(),
                                  np.asarray(params["layers"]["0"]["kernel"]))
    assert state["layers.1.block_conv1.weight"].shape == (16, 32, 3)  # (C_out, C_in, K)
    lstm = params["layers"]["13"]["layers"]
    for j in range(2):
        for jname, tname in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            np.testing.assert_array_equal(state[f"layers.13.lstm.{tname}_l{j}"].numpy(),
                                          np.asarray(lstm[j][jname]))
    # The speech encoder's HIO carry would scramble these kernels.
    hio = params_from_jax(params)
    assert hio["layers.1.block_conv1.weight"].shape == (3, 32, 16)
    with pytest.raises(RuntimeError, match="size mismatch"):
        enc.EncodecEncoder(enc.CONFIG_24K).load_state_dict(hio)
    with pytest.raises(ValueError, match="conv_layout"):
        params_from_jax(params, conv_layout="NCH")


def test_random_init_scheme():
    m = enc.init_encodec_params(enc.EncodecEncoder(enc.CONFIG_48K),
                                torch.Generator().manual_seed(0))
    w = m.layers["0"].weight
    assert w.shape == (32, 2, 7) and w.abs().max() <= (7 * 2) ** -0.5
    assert torch.equal(m.layers["0"].norm_scale, torch.ones(32))
    lstm = m.layers["13"].lstm
    assert lstm.weight_hh_l1.abs().max() <= 512 ** -0.5 and not lstm.bias_ih_l0.any()


# --------------------------------------------------------------------------- #
# Model classes
# --------------------------------------------------------------------------- #


@pytest.fixture
def random_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)


def test_model_24k_frames(random_weights):
    from fadtk_tpu_torch.models.encodec import EncodecEmbModel

    m = EncodecEmbModel("24k")
    audio = np.random.default_rng(2).standard_normal(24001).astype(np.float32) * 0.2
    emb = m.get_embedding(audio[None, :24000])
    assert emb.shape == (75, 128) and emb.dtype == np.float16  # 320 hop: 75 frames/s
    assert m.get_embedding(audio[None, :]).shape == (76, 128)  # causal padding ceils


def test_model_bf16_cast_keeps_the_lstm_bound_to_its_weights(random_weights, monkeypatch):
    """The bf16 mode casts through ``models.base.cast_module``: every
    parameter is bf16, the LSTM's flat weight list is the module's own
    parameters (what cuDNN's buffer is laid out from on the card), and the
    latents equal those of a bare ``.to(bfloat16)`` of the same weights."""
    import copy

    from fadtk_tpu_torch.models.encodec import EncodecEmbModel

    monkeypatch.setenv("FADTK_TPU_BF16", "1")
    m = EncodecEmbModel("24k")
    m.ensure_loaded()
    assert {p.dtype for p in m.module.parameters()} == {torch.bfloat16}
    lstm = next(x for x in m.module.modules() if isinstance(x, torch.nn.LSTM))
    assert all(w is getattr(lstm, n) for w, n in zip(lstm._flat_weights, lstm._flat_weights_names))
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 1, 4800)).astype(np.float32))
    bare = copy.deepcopy(m.module).float().to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(enc.encodec_encode(m.module, audio), enc.encodec_encode(bare, audio))


def test_model_48k_segments(random_weights):
    from fadtk_tpu_torch.models.encodec import EncodecEmbModel

    m = EncodecEmbModel("48k")
    audio = np.random.default_rng(3).standard_normal((2, 120000)).astype(np.float32) * 0.2
    emb = m.get_embedding(audio)
    assert emb.shape == (150 + 150 + 75, 128)  # two full 1 s segments and a 0.5 s tail
    seg = m.get_embedding(audio[:, 48000:96000])
    # segments are independent (a batch of two vs one: float32 ulps before the
    # float16 cast)
    np.testing.assert_allclose(emb[150:300].astype(np.float32), seg.astype(np.float32),
                               atol=2e-3)


def test_load_wav_stereo_and_three_minute_cut(random_weights, tmp_path):
    from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16
    from fadtk_tpu_torch.models.encodec import EncodecEmbModel

    m48, m24 = EncodecEmbModel("48k"), EncodecEmbModel("24k")
    x = np.random.default_rng(4).standard_normal(48000) * 0.1
    f = tmp_path / "a.wav"
    write_wav_int16(f, float_to_int16(x), 48000)
    wav = m48.load_wav(f)
    assert wav.shape == (2, 48000) and wav.dtype == np.float32
    np.testing.assert_array_equal(wav[0], wav[1])  # mono duplicated to stereo
    np.testing.assert_array_equal(wav[0], float_to_int16(x) / 32768.0)
    assert m24.load_wav(f).shape == (1, 48000)
    long = np.zeros(3 * 60 * 24000 + 123, np.int16)
    assert m24.load_wav_array(long).shape == (1, 3 * 60 * 24000)
    assert m48.load_wav_array(np.zeros(3 * 60 * 48000 + 5, np.int16)).shape == (2, 3 * 60 * 48000)


def test_embed_batch_matches_single_clips(random_weights):
    from fadtk_tpu_torch.models.encodec import EncodecEmbModel

    m = EncodecEmbModel("24k")
    rng = np.random.default_rng(5)
    clips = [(rng.standard_normal(n) * 0.2).astype(np.float64)[None, :]
             for n in (24000, 12000, 24000)]
    calls = []
    forward = m._forward
    m._forward = lambda a: calls.append(a.shape) or forward(a)
    batched = m.embed_batch(list(clips))
    assert sorted(calls) == [(1, 1, 12000), (2, 1, 24000)]  # one forward per exact shape
    for clip, got in zip(clips, batched):
        want = m.get_embedding(clip)
        assert got.shape == want.shape and got.dtype == want.dtype == np.float16
        # batched CPU convs may differ from B=1 by float32 ulps before the
        # float16 storage cast (tests/test_encodec.py's bound)
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=2e-3)


# --------------------------------------------------------------------------- #
# Registry
# --------------------------------------------------------------------------- #


def test_registry_parity_with_jax_package():
    """The port registers the JAX registry's speech, codec, VGGish and
    Whisper variants, in its order: 141 of 146."""
    from fadtk_tpu.models.registry import get_all_models as jax_models

    from fadtk_tpu_torch.models.registry import get_all_models

    got = get_all_models()
    names = {m.name for m in got}
    want = [m for m in jax_models() if m.name in names]
    assert [m.name for m in got] == [m.name for m in want]
    assert len(got) == 141 and len(jax_models()) == 146
    for g, w in zip(got, want):
        if g.name.startswith(("encodec-", "dac-")):
            assert (g.name, g.sr, g.num_features, type(g).__name__) == (
                w.name, w.sr, w.num_features, type(w).__name__)
            assert g.cfg.__dict__ == w.cfg.__dict__ and g.weights_name() == w.weights_name()
