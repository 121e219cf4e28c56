"""DAC (44 kHz) and the loudness meter in the PyTorch port against fadtk_tpu on
the CPU.

The loudness module is a copy and must give the JAX package's bits. The
encoder at full width (d_model 64, strides 2/4/8/8, latent 1024) is held
against ``fadtk_tpu``'s ``dac_encode`` with the JAX parameters carried over
and the same numpy audio. The JAX side runs with exact sin
(``FADTK_TPU_EXACT_SIN=1``, read when the snake is traced): the port uses
``torch.sin``, and the JAX default, a Cody-Waite polynomial, is a TPU
workaround the port does not carry. ``dac_encode`` is called outside any jit
here, so no lru-cached executable traced earlier in the worker with the
polynomial can be reused. The model class is checked for its 5 s / 50 %
windows and its cross-file batching.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fadtk_tpu_torch.dsp import loudness
from fadtk_tpu_torch.models import dac_impl
from fadtk_tpu_torch.weights.store import params_from_jax


def _signals():
    rng = np.random.default_rng(0)
    t = np.arange(44100 * 3) / 44100
    return {
        "noise": rng.standard_normal(44100 * 2) * 0.05,
        "sine": np.sin(2 * np.pi * 997.0 * t),
        "stereo": rng.standard_normal((48000, 2)) * 0.1,
        "short": rng.standard_normal(1000) * 0.3,  # shorter than one 400 ms block
        "silent": np.zeros(44100),
        "surround": rng.standard_normal((44100, 5)) * 0.1,
    }


@pytest.mark.parametrize("name", sorted(_signals()))
def test_loudness_bit_equal_to_jax_package(name):
    from fadtk_tpu.dsp import loudness as jax_loudness

    x = _signals()[name]
    sr = 48000 if name == "stereo" else 44100
    got, want = loudness.integrated_loudness(x, sr), jax_loudness.integrated_loudness(x, sr)
    assert got == want or (np.isinf(got) and np.isinf(want)), (got, want)
    if x.ndim == 1:
        y = loudness.normalize_loudness(x, sr, -16.0)
        w = jax_loudness.normalize_loudness(x, sr, -16.0)
        assert y.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(y, w)


def test_loudness_sine_anchor():
    """BS.1770: a 997 Hz full-scale sine reads -3.01 LKFS."""
    assert abs(loudness.integrated_loudness(_signals()["sine"], 44100) - (-3.01)) < 0.1


@pytest.fixture(scope="module")
def pair():
    from fadtk_tpu.models.dac_impl import DAC_44K, init_dac_params

    params = init_dac_params(DAC_44K, jax.random.PRNGKey(0))
    model = dac_impl.DACEncoder(dac_impl.DAC_44K)
    model.load_state_dict(params_from_jax(params, conv_layout="OIH"))  # strict: one to one
    return params, model.eval()


def _jax_exact_sin(params, audio, monkeypatch):
    from fadtk_tpu.models.dac_impl import DAC_44K, dac_encode

    monkeypatch.setenv("FADTK_TPU_EXACT_SIN", "1")
    return np.asarray(dac_encode(DAC_44K, params, jnp.asarray(audio)), np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dac_encode_matches_jax_exact_sin(pair, dtype, monkeypatch):
    """float32: summation order only (measured 1.2e-6 of max|latent|; bound
    1e-5). bf16: both round every conv output and snake to bf16 at different
    points (measured 8.5e-3, against 1.2e-2 between JAX's own bf16 and f32
    latents; bound 5e-2)."""
    from fadtk_tpu.models.precision import cast_params_bf16

    params, model = pair
    audio = (np.random.default_rng(1).standard_normal((2, 1, 6000)) * 0.3).astype(np.float32)
    if dtype == "bfloat16":
        params, model = cast_params_bf16(params), copy.deepcopy(model).to(torch.bfloat16)
    want = _jax_exact_sin(params, audio, monkeypatch)
    with torch.no_grad():
        got = dac_impl.dac_encode(model, torch.from_numpy(audio))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 11, 1024)
    assert _rel(got.numpy(), want) <= (1e-5 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_residual_unit_matches_jax(dilation, monkeypatch):
    """One residual unit (snake, dilated k=7 conv, snake, k=1 conv, skip) at
    each of the encoder's dilations, alphas away from 1."""
    from fadtk_tpu.models.dac_impl import _residual_unit as jax_unit

    rng = np.random.default_rng(dilation)
    unit = dac_impl.ResidualUnit(8)
    dac_impl.init_dac_params(unit, torch.Generator().manual_seed(dilation))
    with torch.no_grad():
        unit.alpha1.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32)))
        unit.alpha2.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 8).astype(np.float32)))
    p = {k: v.detach().numpy() for k, v in unit.state_dict().items()}
    jp = {"alpha1": p["alpha1"], "alpha2": p["alpha2"],
          "conv1": {"kernel": p["conv1.weight"], "bias": p["conv1.bias"]},
          "conv2": {"kernel": p["conv2.weight"], "bias": p["conv2.bias"]}}
    x = (rng.standard_normal((2, 8, 300)) * 0.5).astype(np.float32)
    monkeypatch.setenv("FADTK_TPU_EXACT_SIN", "1")
    want = np.asarray(jax_unit(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), dilation))
    with torch.no_grad():
        got = dac_impl._residual_unit(unit, torch.from_numpy(x), dilation).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)  # summation order


def test_random_init_scheme():
    m = dac_impl.init_dac_params(dac_impl.DACEncoder(dac_impl.DAC_44K),
                                 torch.Generator().manual_seed(0))
    assert m.conv_in.weight.shape == (64, 1, 7) and m.conv_in.weight.abs().max() <= 7 ** -0.5
    assert m.conv_out.weight.shape == (1024, 1024, 3) and not m.conv_out.bias.any()
    assert torch.equal(m.blocks[3].res[2].alpha2, torch.ones(512))
    assert torch.equal(m.alpha_out, torch.ones(1024))


# --------------------------------------------------------------------------- #
# Model class
# --------------------------------------------------------------------------- #


@pytest.fixture
def dac_model(tmp_path, monkeypatch):
    from fadtk_tpu_torch.models.dac import DACModel

    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    return DACModel()


@pytest.mark.parametrize("seconds,n_windows", [(0.5, 1), (5.0, 1), (7.0, 3), (10.0, 3), (12.0, 5)])
def test_windows_match_jax_package(dac_model, seconds, n_windows):
    """Loudness to -16 LUFS, peak limit, zero-pad to whole 5 s windows, 50 %
    overlap: the same windows as the JAX package's model."""
    from fadtk_tpu.models.dac import DACModel as JaxDACModel

    audio = np.random.default_rng(2).standard_normal(int(seconds * 44100)) * 0.5
    got = dac_model._make_windows(audio)
    assert got.shape == (n_windows, 1, 220500) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JaxDACModel()._make_windows(audio))
    assert np.abs(got).max() <= 1.0


def test_one_window_embedding(dac_model):
    emb = dac_model.get_embedding(np.random.default_rng(3).standard_normal(4 * 44100) * 0.1)
    assert emb.shape == (430, 1024) and emb.dtype == np.float16 and np.isfinite(emb).all()


def test_embed_batch_batches_windows_across_files(dac_model, monkeypatch):
    """Windows of several files fill forwards of 8, the last one zero-padded;
    each file gets its own windows' frames back. A stand-in forward writes
    each window's first 430 samples into feature 0 of its frames."""
    dac_model.ensure_loaded()
    calls = []

    def forward(windows):
        calls.append(windows.shape)
        out = np.zeros((windows.shape[0], 430, 1024), np.float32)
        out[:, :, 0] = windows[:, 0, :430]
        return out

    monkeypatch.setattr(dac_model, "_forward", forward)
    rng = np.random.default_rng(4)
    clips = [rng.standard_normal(int(s * 44100)) * 0.1 for s in (10.0, 12.0, 2.0, 7.0)]
    out = dac_model.embed_batch(clips)
    assert calls == [(8, 1, 220500), (8, 1, 220500)]  # 3 + 5 + 1 + 3 = 12 windows
    for clip, emb in zip(clips, out):
        windows = dac_model._make_windows(clip)
        assert emb.shape == (windows.shape[0] * 430, 1024) and emb.dtype == np.float16
        np.testing.assert_array_equal(emb[:, 0], windows[:, 0, :430].reshape(-1).astype(np.float16))


def test_batch_chunked_matches_jax_package():
    from fadtk_tpu.models.base import EmbeddingModel as JaxBase

    from fadtk_tpu_torch.models.base import EmbeddingModel

    rng = np.random.default_rng(5)
    chunks = [rng.standard_normal((n, 3)).astype(np.float32) for n in (2, 0, 5, 1)]
    got = EmbeddingModel._batch_chunked(chunks, lambda g: g * 2.0, batch_size=3)
    want = JaxBase._batch_chunked(chunks, lambda g: g * 2.0, batch_size=3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
