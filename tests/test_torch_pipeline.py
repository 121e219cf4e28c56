"""The slice as a whole: fadtk_tpu and fadtk_tpu_torch score the same datasets
with the same full-width w2v2-base weights on the CPU.

The JAX package's random w2v2-base parameters are saved with its own
``save_params`` as the converted checkpoint both packages load
(``facebook__wav2vec2-base-960h.npz`` under ``FADTK_TPU_CHECKPOINTS``). Each
package then caches embeddings for its own copy of two small datasets (3 and
2 clips of 1.5 s, 16 kHz, as in tests/test_cli.py) and scores them; the
scores must agree. The port's CLI then runs on the CPU
(``FADTK_TPU_TORCH_DEVICE=cpu``) over the port's copies.
"""

import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

# Both packages run the float32 parity path; their hidden states differ by
# summation order (~1e-5 after 12 layers), which can move a cached float16
# embedding by one f16 ulp. Measured |score difference| / score: 6.5e-7.
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
    from fadtk_tpu.models.speech.config import base_config
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params
    from fadtk_tpu.weights.store import save_params

    root = tmp_path_factory.mktemp("slice")
    env = {
        "FADTK_TPU_CHECKPOINTS": str(root / "checkpoints"),
        "FADTK_TPU_TORCH_DEVICE": "cpu",
        "FADTK_TPU_BF16": "",
    }
    with mock.patch.dict(os.environ, env):
        params = init_speech_encoder_params(base_config(do_normalize=False), jax.random.PRNGKey(0))
        save_params(params, root / "checkpoints" / "facebook__wav2vec2-base-960h.npz")
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
            model = get_model("w2v2-base")
            for d in (b, e):
                cache_embedding_files(d, model, workers=2)
            out[pkg] = FrechetAudioDistance(model, load_model=False).score(b, e)
    return out


def test_scores_agree(scored):
    got, want = scored["torch"], scored["jax"]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= SCORE_RTOL * abs(want), (got, want)


def test_embedding_caches_agree(scored):
    """Same file layout and float16 format. Measured: 2006 of 284,160 values
    differ, by at most 1.95e-3 (one f16 ulp at magnitude 2-4)."""
    root = scored["root"]
    for name, n in (("b", 3), ("e", 2)):
        for i in range(n):
            rel = f"{name}/embeddings/w2v2-base/c{i}.npy"
            got, want = np.load(root / "torch" / rel), np.load(root / "jax" / rel)
            assert got.dtype == want.dtype == np.float16
            assert got.shape == want.shape == (74, 768)
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       atol=4e-3, rtol=0)
        for stat in ("mu.npy", "cov.npy"):
            assert (root / "torch" / name / "stats" / "w2v2-base" / stat).exists()


def test_port_cli_on_cpu(scored, monkeypatch):
    from fadtk_tpu_torch.cli.main import main

    root = scored["root"] / "torch"
    csv = root / "out.csv"
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(scored["root"] / "checkpoints"))
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    monkeypatch.setattr(sys, "argv", [
        "fadtk", "w2v2-base", str(root / "b"), str(root / "e"), str(csv), "-w", "2",
    ])
    main()
    lines = csv.read_text().strip().split("\n")
    assert lines[0] == "model,baseline,eval,score,inf_r2,time"
    fields = lines[1].split(",")
    assert fields[:3] == ["w2v2-base", str(root / "b"), str(root / "e")]
    assert float(fields[3]) == scored["torch"]  # cached stats, same evaluator
    assert fields[4] == "None"


def test_port_cli_rejects_unported_flags(monkeypatch, tmp_path):
    """Every flag is ported now; ``--multihost`` still exits with a message
    without ``--device-pipeline``, as the JAX package's CLI does."""
    from fadtk_tpu_torch.cli.main import main

    monkeypatch.setattr(sys, "argv", ["fadtk", "w2v2-base", str(tmp_path), str(tmp_path),
                                      "--multihost"])
    with pytest.raises(SystemExit, match="--multihost requires --device-pipeline"):
        main()
