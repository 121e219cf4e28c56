"""The port's log-mel frontends (``fadtk_tpu_torch.dsp.mel``) against fadtk_tpu.

- the numpy bases (Hann window, HTK and slaney mel banks, the VGGish,
  Whisper and CLAP DFT/mel bases) bit-equal to the JAX package's;
- ``framed_basis_matmul`` against its JAX twin;
- ``whisper_log_mel`` against the JAX one on a 3 s clip in a 30 s window,
  and against HF's WhisperFeatureExtractor (the JAX package's own tolerance,
  tests/test_whisper.py); its DFT, power, mel and log go through the fused
  log-mel wrapper once per call;
- ``vggish_log_mel_examples`` against the JAX one, and the example counts.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.dsp import mel as tmel
from fadtk_tpu_torch.ops import fused_log_mel as k3

# Frontend values against the JAX package and HF: float32 DFT products summed
# in another order (measured <= 2e-6 on these clips); 2e-4 is the JAX
# package's own bound against HF (tests/test_whisper.py:52).
ATOL = 2e-4


@pytest.mark.parametrize("name", ["vggish", "whisper", "clap-laion", "clap-ms"])
def test_bases_bit_equal(name):
    from fadtk_tpu.dsp import mel as jmel

    if name == "vggish":
        got, want = tmel._vggish_bases(), jmel._vggish_bases()
    elif name == "whisper":
        got, want = tmel._whisper_bases(), jmel._whisper_bases()
    else:
        args = (1024, 48000, 64, 50.0, 14000.0) if name == "clap-laion" else (
            1024, 44100, 64, 50.0, 14000.0)
        got, want = tmel._torchlibrosa_bases(*args), jmel._torchlibrosa_bases(*args)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_filterbanks_and_window_bit_equal():
    from fadtk_tpu.dsp import mel as jmel

    np.testing.assert_array_equal(tmel.periodic_hann(400), jmel.periodic_hann(400))
    np.testing.assert_array_equal(tmel.hertz_to_mel([0.0, 125.0, 7500.0]),
                                  jmel.hertz_to_mel([0.0, 125.0, 7500.0]))
    np.testing.assert_array_equal(tmel.mel_filterbank(64, 257, 16000, 125.0, 7500.0),
                                  jmel.mel_filterbank(64, 257, 16000, 125.0, 7500.0))
    np.testing.assert_array_equal(tmel.mel_filterbank_slaney(80, 201, 16000, 0.0, 8000.0),
                                  jmel.mel_filterbank_slaney(80, 201, 16000, 0.0, 8000.0))


@pytest.mark.parametrize("t,window,hop", [(16000, 400, 160), (4000, 1024, 480), (2001, 320, 320)])
def test_framed_basis_matmul_matches_jax(t, window, hop):
    import jax.numpy as jnp

    from fadtk_tpu.dsp.mel import framed_basis_matmul as jax_fbm

    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t)).astype(np.float32)
    basis = rng.standard_normal((window, 33)).astype(np.float32)
    want = np.asarray(jax_fbm(jnp.asarray(x), window, hop, jnp.asarray(basis)))
    got = tmel.framed_basis_matmul(torch.from_numpy(x), window, hop, torch.from_numpy(basis))
    assert got.shape == want.shape == (2, 1 + (t - window) // hop, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def _whisper_clip(seconds=3, seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(16000 * seconds) * 0.3).astype(np.float32)
    clip = np.zeros((1, tmel.WHISPER_SAMPLES), np.float32)
    clip[0, : audio.shape[0]] = audio
    return audio, clip


def test_whisper_log_mel_matches_jax():
    import jax.numpy as jnp

    from fadtk_tpu.dsp.mel import whisper_log_mel as jax_whisper_log_mel

    _, clip = _whisper_clip()
    want = np.asarray(jax_whisper_log_mel(jnp.asarray(clip)))
    got = tmel.whisper_log_mel(torch.from_numpy(clip))
    assert got.dtype == torch.float32 and got.shape == want.shape == (1, 80, 3000)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_whisper_log_mel_matches_hf_feature_extractor():
    from transformers import WhisperFeatureExtractor

    audio, clip = _whisper_clip(seed=1)
    ref = WhisperFeatureExtractor()(audio, sampling_rate=16000, return_tensors="np")
    got = tmel.whisper_log_mel(torch.from_numpy(clip))[0].numpy()
    np.testing.assert_allclose(got, ref.input_features[0], atol=ATOL)


def test_whisper_log_mel_goes_through_the_fused_wrapper_once(monkeypatch):
    """One call of K3's wrapper per batch, in log10_clamp mode, on the
    strided view of the reflect-padded signal."""
    calls = []
    real = k3.fused_log_mel

    def spy(frames, *bases, **kw):
        calls.append((tuple(frames.shape), frames.stride(), kw["log_mode"]))
        return real(frames, *bases, **kw)

    monkeypatch.setattr(k3, "fused_log_mel", spy)
    clips = torch.from_numpy(np.concatenate([_whisper_clip(seed=s)[1] for s in (2, 3)]))
    out = tmel.whisper_log_mel(clips)
    assert out.shape == (2, 80, 3000)
    assert calls == [((2, 3000, 400), (480400, 160, 1), "log10_clamp")]


@pytest.mark.parametrize("n", [16000 * 2 + 123, 16000 * 5, 15600, 399])
def test_vggish_log_mel_examples_match_jax(n):
    import jax.numpy as jnp

    from fadtk_tpu.dsp.mel import vggish_log_mel_examples as jax_examples

    audio = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    want = np.asarray(jax_examples(jnp.asarray(audio)))
    got = tmel.vggish_log_mel_examples(torch.from_numpy(audio))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape[0] == tmel.vggish_num_examples(n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_vggish_example_count():
    for seconds, expected in [(0.9, 0), (0.975, 1), (1.0, 1), (2.0, 2), (10.0, 10)]:
        n = int(seconds * 16000)
        out = tmel.vggish_log_mel_examples(torch.zeros(n))
        assert out.shape == (expected, 96, 64) and tmel.vggish_num_examples(n) == expected
