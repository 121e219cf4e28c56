"""The slice as a whole for WavLM: fadtk_tpu and fadtk_tpu_torch score the same
datasets with the same full-width wavlm-base-plus weights on the CPU.

As tests/test_torch_pipeline.py does for w2v2-base: the JAX package's random
wavlm-base-plus parameters (768 hidden, 12 layers, 12 heads, 320 buckets, max
distance 800) are saved with its own ``save_params`` as the converted
checkpoint both packages load. Each package caches embeddings for its own copy
of two small datasets (3 and 2 clips of 1.5 s, 16 kHz) and scores them; the
scores must agree. The port's CLI then runs on the CPU over the port's copies.
"""

import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

MODEL = "wavlm-base-plus"
WEIGHTS = "patrickvonplaten__wavlm-libri-clean-100h-base-plus.npz"
# Both packages run the float32 parity path (the dense gated-bias attention);
# their hidden states differ by summation order, which can move a cached
# float16 embedding by one f16 ulp. Measured |score difference| / score:
# 4.0e-7 (594.46140 vs 594.46164).
SCORE_RTOL = 1e-5


def _make_dataset(root, name, n_files, seed, sr=16000, seconds=1.5):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = np.arange(int(sr * seconds)) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 1500) * t)
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    from fadtk_tpu.models.registry import get_model as jax_get_model
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params
    from fadtk_tpu.weights.store import save_params

    root = tmp_path_factory.mktemp("wavlm_slice")
    env = {
        "FADTK_TPU_CHECKPOINTS": str(root / "checkpoints"),
        "FADTK_TPU_TORCH_DEVICE": "cpu",
        "FADTK_TPU_BF16": "",
    }
    with mock.patch.dict(os.environ, env):
        cfg = jax_get_model(MODEL).cfg
        assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.intermediate_size,
                cfg.num_buckets, cfg.max_bucket_distance) == (768, 12, 12, 3072, 320, 800)
        params = init_speech_encoder_params(cfg, jax.random.PRNGKey(0))
        save_params(params, root / "checkpoints" / WEIGHTS)
        del params

        out = {"root": root}
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                from fadtk_tpu.models.registry import get_model
                from fadtk_tpu.runner.batch import cache_embedding_files
                from fadtk_tpu.runner.fad import FrechetAudioDistance
            else:
                from fadtk_tpu_torch.models.registry import get_model
                from fadtk_tpu_torch.runner.batch import cache_embedding_files
                from fadtk_tpu_torch.runner.fad import FrechetAudioDistance
            b = _make_dataset(root / pkg, "b", 3, 0)
            e = _make_dataset(root / pkg, "e", 2, 1)
            model = get_model(MODEL)
            for d in (b, e):
                cache_embedding_files(d, model, workers=2)
            out[pkg] = FrechetAudioDistance(model, load_model=False).score(b, e)
    return out


def test_wavlm_scores_agree(scored):
    got, want = scored["torch"], scored["jax"]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= SCORE_RTOL * abs(want), (got, want)


def test_wavlm_embedding_caches_agree(scored):
    """Same file layout and float16 format; values within a few f16 ulps."""
    root = scored["root"]
    for name, n in (("b", 3), ("e", 2)):
        for i in range(n):
            rel = f"{name}/embeddings/{MODEL}/c{i}.npy"
            got, want = np.load(root / "torch" / rel), np.load(root / "jax" / rel)
            assert got.dtype == want.dtype == np.float16
            assert got.shape == want.shape == (74, 768)
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       atol=4e-3, rtol=0)


def test_wavlm_port_cli_on_cpu(scored, monkeypatch):
    from fadtk_tpu_torch.cli.main import main

    root = scored["root"] / "torch"
    csv = root / "out.csv"
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(scored["root"] / "checkpoints"))
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    monkeypatch.setattr(sys, "argv", [
        "fadtk", MODEL, str(root / "b"), str(root / "e"), str(csv), "-w", "2",
    ])
    main()
    fields = csv.read_text().strip().split("\n")[1].split(",")
    assert fields[:3] == [MODEL, str(root / "b"), str(root / "e")]
    assert float(fields[3]) == scored["torch"]  # cached stats, same evaluator
