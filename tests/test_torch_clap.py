"""The port's CLAP (``fadtk_tpu_torch.models.htsat`` / ``clap_laion`` /
``clap_ms`` and ``dsp/mel.py::torchlibrosa_log_mel``) against fadtk_tpu and
HF on the CPU.

The JAX package's random parameters (``init_htsat_params(cfg, PRNGKey(0))``)
reach the port through ``params_from_jax`` (strict: one to one), and the same
numpy inputs go through both. Tolerances: the frontend within 1e-3 dB
(float32 sums in another order, times 10/ln 10); HTSAT f32 within 3e-4
(tests/test_clap.py's bound against HF), bf16 within 0.15 (the JAX package
rounds its one-pass LayerNorm, its softmax and its bias to bf16, the port
keeps those in float32: about two bf16 ulps at |x| ~ 4); the models end to
end within 1e-4 of the largest |value|. The end-to-end cases run the real
frontends with a narrow two-stage tower swapped in (``SMALL64``: 64 mel bins
as the frontends give, embed 8).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.dsp.mel import torchlibrosa_frames, torchlibrosa_log_mel
from fadtk_tpu_torch.models import htsat as ht
from fadtk_tpu_torch.weights.store import params_from_jax

SMALL = dict(spec_size=64, patch_size=4, patch_stride=4, num_mel_bins=16, window_size=4,
             depths=(1, 1), num_heads=(2, 4), embed_dim=8)
SMALL64 = dict(spec_size=256, patch_size=4, patch_stride=4, num_mel_bins=64, window_size=8,
               depths=(1, 1), num_heads=(2, 2), embed_dim=8)
MEL = {"laion": dict(sr=48000, n_fft=1024, hop=480, n_mels=64, fmin=50.0, fmax=14000.0),
       "ms": dict(sr=44100, n_fft=1024, hop=320, n_mels=64, fmin=50.0, fmax=14000.0)}
F32_ATOL = 3e-4
BF16_ATOL = 0.15


@pytest.fixture(autouse=True)
def _cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)


def _jax_params(cfg_kw, projection_dim=None, seed=0, perturb_bn=False):
    import jax

    from fadtk_tpu.models.htsat import HTSATConfig, init_htsat_params

    params = init_htsat_params(HTSATConfig(**cfg_kw), jax.random.PRNGKey(seed),
                               projection_dim=projection_dim)
    params = jax.tree_util.tree_map(np.asarray, params)
    if perturb_bn:  # so the batch norm path is exercised
        rng = np.random.default_rng(seed)
        n = cfg_kw["num_mel_bins"]
        params["batch_norm"] = {
            "mean": rng.uniform(-0.5, 0.5, n).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "bias": rng.uniform(-0.2, 0.2, n).astype(np.float32)}
    return params


def _port(cfg_kw, params, head=None, projection_dim=512):
    model = ht.HTSAT(ht.HTSATConfig(**cfg_kw), head=head, projection_dim=projection_dim)
    model.load_state_dict(params_from_jax(params))  # strict: one to one
    return model.eval()


def _signal(sr, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal(t.shape[0]))


# --------------------------------------------------------------------------- #
# Frontend and constants
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("which", ["laion", "ms"])
def test_torchlibrosa_log_mel_matches_jax(which):
    import jax.numpy as jnp

    from fadtk_tpu.dsp.mel import torchlibrosa_log_mel as jax_log_mel

    kw = MEL[which]
    audio = np.stack([_signal(kw["sr"], 2.0, s) for s in (0, 1)]).astype(np.float32)
    want = np.asarray(jax_log_mel(jnp.asarray(audio), **kw))
    x = torch.from_numpy(audio)
    frames = torchlibrosa_frames(x, kw["n_fft"], kw["hop"])
    assert frames.stride() == (audio.shape[1] + kw["n_fft"], kw["hop"], 1)
    got = torchlibrosa_log_mel(x, **kw)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 1 + audio.shape[1] // kw["hop"], 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_constants_equal_jax():
    from fadtk_tpu.models import htsat as jht

    for t, out in ((100, 256), (1001, 1024), (965, 1024)):
        np.testing.assert_array_equal(ht.bicubic_interp_matrix(t, out),
                                      jht.bicubic_interp_matrix(t, out))
    for window in (4, 8):
        np.testing.assert_array_equal(ht.relative_position_index(window),
                                      jht._relative_position_index(window))
    for args in ((64, 64, 8, 4), (16, 16, 4, 2), (8, 8, 8, 4), (32, 32, 8, 4)):
        np.testing.assert_array_equal(ht.shift_attn_mask(*args), jht._shift_attn_mask(*args))
    assert ht.shift_attn_mask(64, 64, 8, 0) is None


def test_bicubic_matrix_matches_torch_interpolate():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 100, 16)).astype(
        np.float32))
    ref = torch.nn.functional.interpolate(x, (256, 16), mode="bicubic", align_corners=True)
    ours = torch.from_numpy(ht.bicubic_interp_matrix(100, 256)) @ x
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-4)


# --------------------------------------------------------------------------- #
# The tower
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_htsat_small_matches_jax(dtype):
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.htsat import HTSATConfig, htsat_forward

    params = _jax_params(SMALL, perturb_bn=True)
    feats = np.random.default_rng(1).standard_normal((2, 1, 100, 16)).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), params)
    want = np.asarray(htsat_forward(HTSATConfig(**SMALL), jparams, jnp.asarray(feats)),
                      np.float32)
    model = _port(SMALL, params).to(getattr(torch, dtype))
    with torch.no_grad():
        got = ht.htsat_forward(model, torch.from_numpy(feats))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=F32_ATOL if dtype == "float32" else BF16_ATOL)


def test_htsat_small_matches_hf():
    from transformers.models.clap.configuration_clap import ClapAudioConfig
    from transformers.models.clap.modeling_clap import ClapAudioModel

    from fadtk_tpu.weights.clap import convert_clap_audio

    cfg = ht.HTSATConfig(**SMALL)
    torch.manual_seed(0)
    hf = ClapAudioModel(ClapAudioConfig(
        spec_size=64, patch_size=4, patch_stride=[4, 4], num_mel_bins=16, window_size=4,
        depths=[1, 1], num_attention_heads=[2, 4], patch_embeds_hidden_size=8,
        num_classes=10, enable_fusion=False, drop_path_rate=0.0,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)).eval()
    with torch.no_grad():
        hf.audio_encoder.batch_norm.running_mean.uniform_(-0.5, 0.5)
        hf.audio_encoder.batch_norm.running_var.uniform_(0.5, 1.5)
        feats = torch.from_numpy(
            np.random.default_rng(2).standard_normal((2, 1, 100, 16)).astype(np.float32))
        ref = hf(feats).pooler_output
        sd = {f"audio_model.{k}": v for k, v in hf.state_dict().items()}
        got = ht.htsat_forward(_port(SMALL, convert_clap_audio(sd, cfg)), feats)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32_ATOL)


def test_init_scheme_matches_jax_tree():
    """The random init covers the JAX tree one to one: same names and shapes,
    LayerNorm at 1/0, batch norm at its identity, bias-free msclap linears."""
    params = params_from_jax(_jax_params(SMALL64, projection_dim=512))
    model = ht.init_htsat_params(ht.HTSAT(ht.HTSATConfig(**SMALL64), head="laion"),
                                 torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert torch.equal(sd["batch_norm.var"], torch.ones(64))
    assert float(sd["stages.0.blocks.0.intermediate.weight"].abs().max()) <= 8 ** -0.5
    ms = ht.HTSAT(ht.HTSATConfig(**SMALL64), head="msclap", projection_dim=1024)
    assert ms.projection.linear1.bias is None and ms.projection.linear2.bias is None


# --------------------------------------------------------------------------- #
# The models end to end (real frontends, SMALL64 tower)
# --------------------------------------------------------------------------- #


def _model_pair(name, cfg_kw):
    """(JAX model, port model) of one CLAP variant with the SMALL64 tower and
    the same random weights."""
    import jax

    from fadtk_tpu.models.htsat import HTSATConfig
    from fadtk_tpu.models.registry import get_model as jax_model

    from fadtk_tpu_torch.models.registry import get_model

    jm, pm = jax_model(name), get_model(name)
    jm.cfg = HTSATConfig(**cfg_kw)
    pm.cfg = ht.HTSATConfig(**cfg_kw)
    if name == "clap-2023":
        params = _jax_params(cfg_kw, seed=3)
        rng = np.random.default_rng(3)
        d = jm.cfg.num_features
        params["projection"] = {
            "linear1": {"kernel": (rng.standard_normal((d, 1024)) * 0.3).astype(np.float32)},
            "linear2": {"kernel": (rng.standard_normal((1024, 1024)) * 0.02).astype(np.float32)},
            "layer_norm": {"scale": rng.uniform(0.5, 1.5, 1024).astype(np.float32),
                           "bias": rng.uniform(-0.1, 0.1, 1024).astype(np.float32)}}
        head, dim = "msclap", 1024
    else:
        params = _jax_params(cfg_kw, projection_dim=512, seed=4, perturb_bn=True)
        head, dim = "laion", 512
    jm.params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jm.loaded = True
    pm.device = torch.device("cpu")
    pm.module = _port(cfg_kw, params, head=head, projection_dim=dim)
    pm._bf16_active = False
    pm.loaded = True
    return jm, pm


@pytest.mark.parametrize("name,seconds", [("clap-laion-audio", 2.5), ("clap-2023", 1.5)])
def test_model_embed_matches_jax(name, seconds):
    jm, pm = _model_pair(name, SMALL64)
    audio = _signal(pm.sr, seconds) * 4.0  # past full scale: the quantize clip
    want = np.asarray(jm._embed(audio))
    got = pm._embed(audio)
    n_chunks = int(np.ceil(seconds))
    assert got.shape == want.shape == (n_chunks, pm.num_features) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)
    norms = np.linalg.norm(got, axis=1)
    if name == "clap-2023":
        assert not np.allclose(norms, 1.0, atol=0.3)  # msclap does not normalise
    else:
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_quantize_roundtrip_and_chunks():
    from fadtk_tpu.models.clap_laion import CLAPLaionModel as JaxLaion

    from fadtk_tpu_torch.models.clap_laion import CLAPLaionModel

    x = np.array([0.0, 0.5, 1.2, -1.2, 1.0 / 32767, -0.3])
    np.testing.assert_array_equal(CLAPLaionModel._quantize_roundtrip(x),
                                  JaxLaion._quantize_roundtrip(x))
    m, jm = CLAPLaionModel("audio"), JaxLaion("audio")
    for n in (24000, 480000, 480001, 1000000):
        audio = _signal(48000, n / 48000)
        np.testing.assert_array_equal(m._make_chunks(audio), jm._make_chunks(audio))


def test_embed_batch_equals_per_file(monkeypatch):
    """Cross-file batches of 32 chunks (here 3 files, 33 chunks: a full
    batch and a zero-padded one) equal per-file ``_embed``."""
    _, pm = _model_pair("clap-laion-audio", SMALL64)
    calls = []
    forward = pm._forward_chunks
    monkeypatch.setattr(pm, "_forward_chunks", lambda c: calls.append(c.shape) or forward(c))
    clips = [_signal(48000, s, i) for i, s in enumerate((30.0, 0.4, 2.2))]
    got = pm.embed_batch(clips)
    assert calls == [(32, 480000), (32, 480000)]
    for clip, g in zip(clips, got, strict=True):
        want = pm._embed(clip)
        assert g.dtype == np.float16 and g.shape == want.shape
        np.testing.assert_allclose(g.astype(np.float32), want, atol=2e-3)


# --------------------------------------------------------------------------- #
# Model classes and registry
# --------------------------------------------------------------------------- #


def test_registry_parity_with_jax_package():
    from fadtk_tpu.models.registry import get_all_models as jax_models

    from fadtk_tpu_torch.models.registry import get_all_models

    want = [m for m in jax_models() if m.name.startswith("clap-")]
    got = [m for m in get_all_models() if m.name.startswith("clap-")]
    assert [m.name for m in got] == [m.name for m in want] == [
        "clap-2023", "clap-laion-audio", "clap-laion-music"]
    for g, w in zip(got, want, strict=True):
        assert (g.name, g.sr, g.num_features, g.min_len, g.weights_name(), type(g).__name__) == (
            w.name, w.sr, w.num_features, w.min_len, w.weights_name(), type(w).__name__)
        assert dataclasses.asdict(g.cfg) == dataclasses.asdict(w.cfg)
    assert tuple(got[0].mel) == tuple(want[0].mel)


def test_missing_weights_names_the_checkpoint(monkeypatch):
    from fadtk_tpu.models.registry import get_model as jax_model
    from fadtk_tpu.weights.store import MissingWeightsError as JaxMissing

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.weights.store import MissingWeightsError

    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    for name in ("clap-2023", "clap-laion-audio", "clap-laion-music"):
        with pytest.raises(JaxMissing) as want:
            jax_model(name).load_model()
        with pytest.raises(MissingWeightsError) as got:
            get_model(name).ensure_loaded()
        assert str(got.value) == str(want.value)


def test_random_weights_and_stored_meta(monkeypatch, tmp_path):
    """FADTK_TPU_RANDOM_WEIGHTS builds the tower from a seed; a converted
    ``.npz`` with ``__config__`` loads, its fields split into mel and HTSAT
    ones for clap-2023."""
    from fadtk_tpu.weights.store import save_params

    from fadtk_tpu_torch.models.clap_ms import MSCLAPModel
    from fadtk_tpu_torch.models.registry import get_model

    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    m = get_model("clap-laion-audio")
    m.cfg = ht.HTSATConfig(**SMALL64)
    emb = m.get_embedding(_signal(48000, 1.5))
    assert emb.shape == (2, 512) and emb.dtype == np.float16

    params = _jax_params(SMALL64, seed=5)
    params["projection"] = {"linear1": {"kernel": np.zeros((16, 1024), np.float32)},
                            "linear2": {"kernel": np.zeros((1024, 1024), np.float32)},
                            "layer_norm": {"scale": np.ones(1024, np.float32),
                                           "bias": np.zeros(1024, np.float32)}}
    meta = {**SMALL64, "hop": 441, "fmax": 16000.0}
    params["__config__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    save_params(params, tmp_path / "msclap_2023.npz")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path))
    m = MSCLAPModel()
    m.ensure_loaded()
    assert m.mel.hop == 441 and m.mel.fmax == 16000.0 and m.mel.n_fft == 1024
    assert m.cfg == ht.HTSATConfig(**SMALL64)
    assert m.get_embedding(_signal(44100, 1.0)).shape == (1, 1024)
