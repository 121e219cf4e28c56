"""The mel families as a whole: fadtk_tpu and fadtk_tpu_torch score the same
datasets with the same full-width whisper-tiny and vggish weights on the CPU.

As tests/test_torch_codec_pipeline.py does for EnCodec: the JAX package's
random parameters (``init_whisper_params(config_for_size("tiny"),
PRNGKey(0))``, ``init_vggish_params(PRNGKey(0))``) are saved with its own
``save_params`` as the converted checkpoints the port loads, while the JAX
package runs its random-weights mode, which makes the same parameters. Each
package caches embeddings for its own copy of two small datasets (6 clips of
30 s at 16 kHz each, one full Whisper window, 31 VGGish examples; sines and
noise at random levels, so that the embeddings of random weights vary from
clip to clip well beyond a float16 ulp) and scores them; the scores must
agree. The port's CLI then runs on the CPU with random weights for both
models.
"""

import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

# Both packages run the float32 parity path; their embeddings differ by
# summation order (~1e-6 relative), which can move a cached float16 value by
# one f16 ulp. Measured |score difference| / score: 9.6e-7 (whisper-tiny,
# 0.51197), 7.8e-7 (vggish, 8.2996e-6: random weights give small embeddings).
SCORE_RTOL = 1e-5
# model -> embedding frames of one 30 s clip, features
MODELS = {"whisper-tiny": (2, 384), "vggish": (31, 128)}


def _make_dataset(root, name, n_files, seed, sr=16000, seconds=30.0):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        t = np.arange(int(sr * seconds)) / sr
        x = rng.uniform(0.05, 0.6) * np.sin(2 * np.pi * rng.uniform(100, 4000) * t)
        x += rng.uniform(0.01, 0.3) * rng.standard_normal(t.shape[0])
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


def _save_jax_params(root):
    from fadtk_tpu.models.vggish import init_vggish_params
    from fadtk_tpu.models.whisper_impl import config_for_size, init_whisper_params
    from fadtk_tpu.weights.store import save_params

    key = jax.random.PRNGKey(0)
    save_params(init_whisper_params(config_for_size("tiny"), key),
                root / "checkpoints" / "openai__whisper-tiny.npz")
    save_params(init_vggish_params(key), root / "checkpoints" / "vggish.npz")


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    root = tmp_path_factory.mktemp("mel_slice")
    common = {"FADTK_TPU_TORCH_DEVICE": "cpu", "FADTK_TPU_BF16": ""}
    envs = {
        "jax": {**common, "FADTK_TPU_CHECKPOINTS": str(root / "none"),
                "FADTK_TPU_RANDOM_WEIGHTS": "1"},
        "torch": {**common, "FADTK_TPU_CHECKPOINTS": str(root / "checkpoints"),
                  "FADTK_TPU_RANDOM_WEIGHTS": "0"},
    }
    _save_jax_params(root)
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
            b = _make_dataset(root / pkg, "b", 6, 0)
            e = _make_dataset(root / pkg, "e", 6, 1)
            for name in MODELS:
                model = get_model(name)
                for d in (b, e):
                    cache_embedding_files(d, model, workers=2)
                out[pkg, name] = FrechetAudioDistance(model, load_model=False).score(b, e)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_scores_agree(scored, name):
    got, want = scored["torch", name], scored["jax", name]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= SCORE_RTOL * abs(want), (got, want, abs(got - want) / want)


@pytest.mark.parametrize("name", list(MODELS))
def test_embedding_caches_agree(scored, name):
    """Same file layout and float16 format; values within a few f16 ulps."""
    root = scored["root"]
    for ds in ("b", "e"):
        for i in range(6):
            rel = f"{ds}/embeddings/{name}/c{i}.npy"
            got, want = np.load(root / "torch" / rel), np.load(root / "jax" / rel)
            assert got.dtype == want.dtype == np.float16
            assert got.shape == want.shape == MODELS[name]
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name,bf16", [("whisper-tiny", False), ("vggish", False),
                                       ("vggish", True)])
def test_port_cli_on_cpu_with_random_weights(name, bf16, tmp_path, monkeypatch):
    from fadtk_tpu_torch.cli.main import main
    from fadtk_tpu_torch.ops import fused_log_mel as k3

    b = _make_dataset(tmp_path, "b", 2, 2, seconds=1.5)
    e = _make_dataset(tmp_path, "e", 2, 3, seconds=1.5)
    csv = tmp_path / "out.csv"
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    # Set, not deleted: monkeypatch then undoes the "1" that main() writes
    # for --bf16, which would otherwise leak into the worker's later tests.
    monkeypatch.setenv("FADTK_TPU_BF16", "")
    monkeypatch.setattr(sys, "argv", ["fadtk", name, str(b), str(e), str(csv), "-w", "2",
                                      *(["--bf16"] if bf16 else [])])
    before = k3.fused_log_mel.launches
    main()
    key = name + ("-bf16" if bf16 else "")
    fields = csv.read_text().strip().split("\n")[1].split(",")
    assert fields[0] == key and np.isfinite(float(fields[3]))
    emb = np.load(b / "embeddings" / key / "c0.npy")
    frames = 2 if name == "whisper-tiny" else 1  # 1.5 s: one 0.96 s example
    assert emb.shape == (frames, MODELS[name][1]) and emb.dtype == np.float16
    assert k3.fused_log_mel.launches == before  # CPU: the twin, no kernel launch
