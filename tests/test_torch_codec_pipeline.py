"""The codec slice as a whole: fadtk_tpu and fadtk_tpu_torch score the same
datasets with the same full-width encodec-emb weights on the CPU.

As tests/test_torch_wavlm_pipeline.py does for WavLM, with one difference: the
JAX package's random 24 kHz EnCodec parameters (32 filters, ratios 8/5/4/2, a
2-layer LSTM of 512) are saved with its own ``save_params`` as the converted
checkpoint (``encodec_24k.npz``) the port loads, while the JAX package runs
its random-weights mode, which makes the same parameters
(``init_encodec_params(cfg, PRNGKey(0))``): its ``load_params`` cannot read
an EnCodec tree back (the HF-indexed ``layers`` dict has gaps, which its
``unflatten_pytree`` takes for a list). Each package caches embeddings for
its own copy of two small datasets (3 clips of 1 s at 24 kHz each, so every
forward has one shape) and scores them; the scores must agree. The port's CLI
then runs on the CPU over the port's copies, for encodec-emb with the fused
block's knob on, and for encodec-emb-48k with random weights.
"""

import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

MODEL = "encodec-emb"
# Both packages run the float32 parity path; their latents differ by summation
# order (~1e-6 relative), which can move a cached float16 embedding by one f16
# ulp. Measured |score difference| / score: 1.1e-7 (2.963727e-4 both; random
# weights give small latents).
SCORE_RTOL = 1e-5


def _make_dataset(root, name, n_files, seed, sr=24000, seconds=1.0):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = np.arange(int(sr * seconds)) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 1500) * t)
        x += 0.05 * rng.standard_normal(t.shape[0])
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    from fadtk_tpu.models.encodec_impl import CONFIG_24K, init_encodec_params
    from fadtk_tpu.weights.store import save_params

    root = tmp_path_factory.mktemp("codec_slice")
    common = {"FADTK_TPU_TORCH_DEVICE": "cpu", "FADTK_TPU_BF16": "", "FADTK_TPU_FUSED_RESNET": ""}
    envs = {
        "jax": {**common, "FADTK_TPU_CHECKPOINTS": str(root / "none"),
                "FADTK_TPU_RANDOM_WEIGHTS": "1"},
        "torch": {**common, "FADTK_TPU_CHECKPOINTS": str(root / "checkpoints"),
                  "FADTK_TPU_RANDOM_WEIGHTS": "0"},
    }
    save_params(init_encodec_params(CONFIG_24K, jax.random.PRNGKey(0)),
                root / "checkpoints" / "encodec_24k.npz")
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
        with mock.patch.dict(os.environ, envs[pkg]):
            b = _make_dataset(root / pkg, "b", 3, 0)
            e = _make_dataset(root / pkg, "e", 3, 1)
            model = get_model(MODEL)
            for d in (b, e):
                cache_embedding_files(d, model, workers=2)
            out[pkg] = FrechetAudioDistance(model, load_model=False).score(b, e)
    return out


def test_encodec_scores_agree(scored):
    got, want = scored["torch"], scored["jax"]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= SCORE_RTOL * abs(want), (got, want)


def test_encodec_embedding_caches_agree(scored):
    """Same file layout and float16 format (75 frames of 128 per second);
    values within a few f16 ulps."""
    root = scored["root"]
    for name in ("b", "e"):
        for i in range(3):
            rel = f"{name}/embeddings/{MODEL}/c{i}.npy"
            got, want = np.load(root / "torch" / rel), np.load(root / "jax" / rel)
            assert got.dtype == want.dtype == np.float16
            assert got.shape == want.shape == (75, 128)
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       atol=1e-3, rtol=0)


def _cli(argv, monkeypatch, env):
    from fadtk_tpu_torch.cli.main import main

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    monkeypatch.setattr(sys, "argv", ["fadtk", *argv])
    main()


def test_encodec_port_cli_on_cpu_with_the_fused_block(scored, monkeypatch):
    """The knob on: the blocks take the fused wrapper's CPU twin; the cached
    embeddings and stats of the f32 run give the same score."""
    from fadtk_tpu_torch.ops import fused_resnet as fr

    root = scored["root"] / "torch"
    csv = root / "out.csv"
    before = fr.fused_resnet_causal.launches
    _cli([MODEL, str(root / "b"), str(root / "e"), str(csv), "-w", "2"], monkeypatch,
         {"FADTK_TPU_CHECKPOINTS": str(scored["root"] / "checkpoints"),
          "FADTK_TPU_FUSED_RESNET": "1"})
    fields = csv.read_text().strip().split("\n")[1].split(",")
    assert fields[:3] == [MODEL, str(root / "b"), str(root / "e")]
    assert float(fields[3]) == scored["torch"]  # cached stats, same evaluator
    assert fr.fused_resnet_causal.launches == before  # CPU: no kernel launch


def test_encodec_48k_port_cli_on_cpu(tmp_path, monkeypatch):
    """encodec-emb-48k with random weights: stereo from mono, 1 s segments
    and a tail, (150 + 75) frames for 1.5 s."""
    b = _make_dataset(tmp_path, "b", 3, 2, sr=48000, seconds=1.5)
    e = _make_dataset(tmp_path, "e", 3, 3, sr=48000, seconds=1.5)
    csv = tmp_path / "out.csv"
    _cli(["encodec-emb-48k", str(b), str(e), str(csv), "-w", "2"], monkeypatch,
         {"FADTK_TPU_CHECKPOINTS": str(tmp_path / "none"), "FADTK_TPU_RANDOM_WEIGHTS": "1"})
    score = float(csv.read_text().strip().split("\n")[1].split(",")[3])
    assert np.isfinite(score)
    emb = np.load(b / "embeddings" / "encodec-emb-48k" / "c0.npy")
    assert emb.shape == (225, 128) and emb.dtype == np.float16
