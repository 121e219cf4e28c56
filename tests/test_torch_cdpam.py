"""The port's CDPAM (``fadtk_tpu_torch.models.cdpam_impl`` / ``cdpam``)
against fadtk_tpu on the CPU.

The JAX package's random parameters (``init_cdpam_params(PRNGKey(0))``)
reach the port through ``params_from_jax`` (strict: one to one; conv kernels
(K, C_in, C_out) -> (C_out, C_in, K), head kernels transposed), and the same
seeded int16-scale chunks with ragged valid lengths go through both forwards.
Bounds relative to the largest |value|: f32 1e-5 (summation order only);
bf16 0.15, the bound the other families' bf16 cases use (both round every
conv output to bf16, at points XLA and torch's CPU kernels order
differently, through 16 layers). Then the per-layer masking (a padded chunk
equals its exact-length run), the model class end to end against the JAX
package's on a 2.3 s clip, cross-file batching, unit norms and a narrow
stored ``__config__`` geometry.
"""

import json

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models import cdpam_impl as tc
from fadtk_tpu_torch.weights.store import params_from_jax

SMALL = dict(channels=(8, 8, 16, 16, 32), kernel_size=3, emb_dim=24, chunk_samples=500)
RTOL_OF_MAX = {"float32": 1e-5, "bfloat16": 0.15}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)


def _jax_params(cfg_kw, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.cdpam_impl import CdpamConfig, init_cdpam_params

    return init_cdpam_params(jax.random.PRNGKey(0), CdpamConfig(**cfg_kw), getattr(jnp, dtype))


def _port(cfg_kw, params, dtype="float32"):
    model = tc.CdpamEncoder(tc.CdpamConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(params))  # strict: one to one
    return model.eval().to(getattr(torch, dtype))


def _chunks(size, lengths, seed):
    """Seeded int16-scale chunks, zero past each valid length."""
    x = np.random.default_rng(seed).standard_normal((len(lengths), size)) * 3000
    for i, n in enumerate(lengths):
        x[i, n:] = 0
    return x.astype(np.float32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    """Published geometry (16 layers, 512-d heads), one full and three
    ragged 1 s chunks."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.cdpam_impl import DEFAULT_CONFIG, cdpam_forward

    params = _jax_params({}, dtype)
    model = _port({}, params, dtype)
    x, lengths = _chunks(22050, [22050, 17001, 300, 1], seed=1)
    want = jax.jit(partial(cdpam_forward, DEFAULT_CONFIG))(params, jnp.asarray(x),
                                                           jnp.asarray(lengths))
    with torch.no_grad():
        got = tc.cdpam_forward(model, torch.from_numpy(x), torch.from_numpy(lengths))
    for g, w, shape in zip(got, want, [(4, 512)] * 3):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape == shape
        err = np.abs(g.numpy() - w).max()
        assert err <= RTOL_OF_MAX[dtype] * np.abs(w).max(), err


def test_padded_equals_unpadded():
    """A ragged chunk inside the padded bucket equals its exact-length run:
    the per-layer re-zeroing makes the zero tail invisible."""
    params = _jax_params(SMALL)
    model = _port(SMALL, params)
    rng = np.random.default_rng(1)
    for valid in (500, 463, 129, 32, 5, 1):
        x = (rng.standard_normal(valid) * 3000).astype(np.float32)
        padded = np.zeros((1, 500), np.float32)
        padded[0, :valid] = x
        n = torch.tensor([valid], dtype=torch.int32)
        with torch.no_grad():
            exact = tc.cdpam_forward(model, torch.from_numpy(x[None]), n)
            bucket = tc.cdpam_forward(model, torch.from_numpy(padded), n)
        for a, b in zip(exact, bucket):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_l2_normalize_matches_torch():
    import torch.nn.functional as F

    v = np.random.default_rng(3).standard_normal((5, 16)).astype(np.float32)
    v[2] = 0  # the eps clamp
    got = tc.l2_normalize(torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), F.normalize(torch.from_numpy(v), dim=1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_random_init_scheme():
    model = tc.init_cdpam_params(tc.CdpamEncoder(tc.CdpamConfig(**SMALL)),
                                 torch.Generator().manual_seed(0))
    conv = model.convs[1]
    bound = 1 / np.sqrt(3 * 8)
    w = conv.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    assert float(conv.bias.abs().max()) == 0.0
    for bn in model.norms:
        assert torch.all((bn.var >= 1.0) & (bn.var <= 1.1)) and float(bn.var.std()) > 0
        assert float(bn.mean.abs().max()) == 0 and float((bn.weight - 1).abs().max()) == 0


def _save_jax_params(tmp_path, monkeypatch, params, meta=None):
    from fadtk_tpu.weights.store import save_params

    params = dict(params)
    if meta is not None:
        params["__config__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    save_params(params, tmp_path / "cdpam.npz")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path))


@pytest.mark.parametrize("mode", ["acoustic", "content"])
def test_model_matches_jax_package(mode, tmp_path, monkeypatch):
    """CdpamModel.get_embedding end to end on a 2.3 s clip (two full chunks
    and a ragged tail), both packages loading the same stored weights."""
    from fadtk_tpu.models.registry import get_model as jax_model

    from fadtk_tpu_torch.models.registry import get_model

    _save_jax_params(tmp_path, monkeypatch, _jax_params({}))
    sr = 22050
    t = np.arange(int(sr * 2.3)) / sr
    audio = (np.sin(2 * np.pi * 440 * t) * 12000
             + np.random.default_rng(4).standard_normal(t.size) * 500).astype(np.float32)
    want = jax_model(f"cdpam-{mode}").get_embedding(audio).astype(np.float32)
    got = get_model(f"cdpam-{mode}").get_embedding(audio)
    assert got.dtype == np.float16 and got.shape == want.shape == (3, 512)
    # float16 storage of unit vectors: both round the same float32 values
    # (within 1e-5 of each other) to float16, one ulp apart at most.
    np.testing.assert_allclose(got.astype(np.float32), want, atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.astype(np.float32), axis=1), 1.0, atol=2e-3)


def test_acoustic_differs_from_content():
    from fadtk_tpu_torch.models.registry import get_model

    audio = (np.random.default_rng(5).standard_normal(22050) * 8000).astype(np.float32)
    a, c = get_model("cdpam-acoustic"), get_model("cdpam-content")
    for m in (a, c):
        m.cfg = tc.CdpamConfig(**{**SMALL, "chunk_samples": 22050})
    ea, ec = a.get_embedding(audio), c.get_embedding(audio)
    assert ea.shape == ec.shape == (1, 24)
    assert not np.allclose(ea, ec)


def test_embed_batch_equals_single(monkeypatch):
    """Chunks of several files share the padded batches: equal to each file
    alone, and one forward for the lot."""
    from fadtk_tpu_torch.models.registry import get_model

    model = get_model("cdpam-acoustic")
    model.cfg = tc.CdpamConfig(**{**SMALL, "chunk_samples": 22050})
    model.ensure_loaded()
    rng = np.random.default_rng(6)
    clips = [(rng.standard_normal(n) * 9000).astype(np.float32) for n in (22050, 50000, 7001)]
    calls = []
    head = model._head
    monkeypatch.setattr(model, "_head", lambda c, n: calls.append(c.shape) or head(c, n))
    batched = model.embed_batch(clips)
    assert calls == [(model.CHUNK_BATCH, 22050)]
    single = [model.get_embedding(c) for c in clips]
    assert [b.shape for b in batched] == [(1, 24), (3, 24), (1, 24)]
    for b, s in zip(batched, single):
        assert b.dtype == s.dtype == np.float16
        np.testing.assert_allclose(b.astype(np.float32), s.astype(np.float32), atol=2e-3)


def test_chunking_matches_jax_package():
    """The reference's 1 s non-overlapping chunks with a ragged tail."""
    from fadtk_tpu.models.registry import get_model as jax_model

    from fadtk_tpu_torch.models.registry import get_model

    audio = (np.random.default_rng(7).standard_normal(50000) * 5000).astype(np.float32)
    for got, want in zip(get_model("cdpam-content")._chunk(audio),
                         jax_model("cdpam-content")._chunk(audio)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(get_model("cdpam-content")._chunk(audio)[1], [22050, 22050, 5900])


def test_load_wav_is_int16_scale(tmp_path):
    from fadtk_tpu_torch.audio.wavio import write_wav_int16
    from fadtk_tpu_torch.models.registry import get_model

    pcm = np.array([0, 1, -2, 32767, -32768], np.int16)
    write_wav_int16(tmp_path / "a.wav", pcm, 22050)
    m = get_model("cdpam-acoustic")
    for got in (m.load_wav(tmp_path / "a.wav"), m.load_wav_array(pcm)):
        assert got.dtype == np.float32 and np.array_equal(got, pcm.astype(np.float32))


def test_stored_config_geometry(tmp_path, monkeypatch):
    """A converted checkpoint of another geometry (two convs of kernel 5,
    12-d heads) loads through its ``__config__`` and runs."""
    alt = dict(channels=(4, 8), kernel_size=5, emb_dim=12, chunk_samples=300)
    params = _jax_params(alt)
    _save_jax_params(tmp_path, monkeypatch, params,
                     {"channels": [4, 8], "kernel_size": 5, "emb_dim": 12})
    from fadtk_tpu_torch.models.cdpam import CdpamModel

    model = CdpamModel("acoustic")
    model.ensure_loaded()
    assert model.cfg.channels == (4, 8) and model.cfg.kernel_size == 5
    assert model.cfg.emb_dim == 12 and model.cfg.chunk_samples == 22050
    emb = model.get_embedding(np.zeros(30000, np.float32))
    assert emb.shape == (2, 12) and np.isfinite(emb).all()


def test_missing_weights_message_matches_jax(monkeypatch):
    from fadtk_tpu.models.registry import get_model as jax_model
    from fadtk_tpu.weights.store import MissingWeightsError as JaxMissing

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.weights.store import MissingWeightsError

    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS")
    with pytest.raises(JaxMissing) as want:
        jax_model("cdpam-acoustic").load_model()
    with pytest.raises(MissingWeightsError) as got:
        get_model("cdpam-acoustic").ensure_loaded()
    assert str(got.value) == str(want.value)
