"""The port's embeds / package / test-harness CLIs and its reference-path
facades, on the CPU.

- ``cache_embedding_files_multi``: the per-layer variants of one speech
  backbone share one forward per file (counted), every layer's ``.npy``
  equals the single-variant path's, files whose caches exist are skipped,
  other models go through ``cache_embedding_files``;
- ``python -m fadtk_tpu_torch.embeds`` and ``.package`` (the ``.npz`` keys
  and values, the confirmation for other suffixes);
- the golden-score harness: exit 0 on a self-consistent synthetic golden
  CSV, 2 on a perturbed one, 1 on an embedding error, SKIPPED without
  weights (tests/test_harness.py's fixtures, with the port scoring);
- the facades: the package's ``__all__`` covers the JAX package's, each
  reference submodule exports the JAX twin's ``__all__``, and importing them
  leaves no ``jax`` in ``sys.modules``.

The speech model is tests/test_torch_device_pipeline.py's narrow encoder
(hidden 64, 2 layers, 8 kHz) in three per-layer variants of one backbone.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16
from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel
from fadtk_tpu_torch.runner.batch import cache_embedding_files, cache_embedding_files_multi

from test_torch_device_pipeline import CFG, SR

REPO = Path(__file__).resolve().parents[1]


def variant(layer: int | None) -> SpeechEmbeddingModel:
    """A per-layer variant of one narrow backbone; None is the default name
    (the last layer)."""
    name = "tiny-speech" if layer is None else f"tiny-speech-{layer}"
    return SpeechEmbeddingModel(name, 64, SR, CFG, CFG.num_layers if layer is None else layer,
                                "test/tiny-speech")


def _models():
    from fadtk_tpu_torch.models.registry import get_model

    return [variant(0), variant(1), variant(None), get_model("vggish")]


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "no-checkpoints"))
    monkeypatch.setenv("FADTK_TPU_BF16", "")  # set, so the CLIs' writes are undone


def _make_dataset(d: Path, n: int, seed: int, seconds=(1.0, 1.6)) -> Path:
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        sr = 16000 if i == 1 else SR  # one file resamples
        t = np.arange(int(sr * rng.uniform(*seconds))) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 1500) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


def _npys(d: Path, name: str) -> dict[str, np.ndarray]:
    return {f.name: np.load(f) for f in sorted((d / "embeddings" / name).glob("*.npy"))}


def test_multi_one_forward_per_file_and_equal_layers(tmp_path, monkeypatch):
    multi = _make_dataset(tmp_path / "multi", 3, seed=0)
    single = tmp_path / "single"
    shutil.copytree(multi, single)
    calls = []
    forward = SpeechEmbeddingModel._forward
    monkeypatch.setattr(SpeechEmbeddingModel, "_forward",
                        lambda self, a, n, taps: calls.append(taps) or forward(self, a, n, taps))
    cache_embedding_files_multi(_models(), multi, workers=1)
    assert calls == [None] * 3  # one all-layer forward per file
    assert len(_npys(multi, "vggish")) == 3  # the other model went the single way

    for m in _models()[:3]:
        cache_embedding_files(single, m, workers=1)
        got, want = _npys(multi, m.name), _npys(single, m.name)
        assert list(got) == list(want) == ["c0.npy", "c1.npy", "c2.npy"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.float16 and got[k].shape == want[k].shape
            # B=1 against batched forwards: float32 sums in another order
            # before the float16 cast.
            np.testing.assert_allclose(got[k].astype(np.float32), want[k].astype(np.float32),
                                       atol=2e-3 * np.abs(want[k]).max(), rtol=0)

    calls.clear()
    (multi / "embeddings" / "tiny-speech-1" / "c2.npy").unlink()
    before = {k: v.copy() for k, v in _npys(multi, "tiny-speech").items()}
    cache_embedding_files_multi(_models(), multi, workers=1)
    assert calls == [None]  # only the file with a missing cache
    assert (multi / "embeddings" / "tiny-speech-1" / "c2.npy").exists()
    after = _npys(multi, "tiny-speech")
    assert all(np.array_equal(before[k], after[k]) for k in before)  # present caches kept


def _cli(monkeypatch, module, models, *argv):
    monkeypatch.setattr(module, "get_all_models", lambda: models)
    monkeypatch.setattr(sys, "argv", ["prog", *map(str, argv)])
    module.main()


def test_embeds_cli(tmp_path, monkeypatch):
    from fadtk_tpu_torch.cli import embeds

    a = _make_dataset(tmp_path / "a", 2, seed=1)
    b = _make_dataset(tmp_path / "b", 2, seed=2)
    models = [variant(1), variant(None)]
    _cli(monkeypatch, embeds, models, "-m", "tiny-speech-1", "tiny-speech", "-d", a, b,
         "-w", "1")
    for d in (a, b):
        for name in ("tiny-speech-1", "tiny-speech"):
            assert len(_npys(d, name)) == 2
    _cli(monkeypatch, embeds, [variant(1), variant(None)], "-m", "tiny-speech", "-d", a,
         "--bf16")
    assert len(_npys(a, "tiny-speech-bf16")) == 2
    with pytest.raises(SystemExit):  # an unknown name is refused by argparse
        _cli(monkeypatch, embeds, models, "-m", "nope", "-d", a)


def test_package_npz(tmp_path, monkeypatch):
    from fadtk_tpu_torch.cli import package
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    d = _make_dataset(tmp_path / "d", 3, seed=3)
    out = tmp_path / "out" / "base.npz"
    models = [variant(1), variant(None)]
    _cli(monkeypatch, package, models, d, out, "--models", "tiny-speech-1", "tiny-speech",
         "-w", "1")
    with np.load(out) as z:
        assert sorted(z.files) == ["tiny-speech-1.cov", "tiny-speech-1.mu",
                                   "tiny-speech.cov", "tiny-speech.mu"]
        for m in models:
            mu, cov = FrechetAudioDistance(m, load_model=False).load_stats(d)
            assert np.array_equal(z[f"{m.name}.mu"], mu) and np.array_equal(z[f"{m.name}.cov"], cov)
            assert mu.shape == (64,) and cov.shape == (64, 64)

    with pytest.raises(SystemExit, match="Unknown models"):
        _cli(monkeypatch, package, models, d, out, "--models", "nope")
    monkeypatch.setattr("builtins.input", lambda: "n")
    with pytest.raises(SystemExit) as e:
        _cli(monkeypatch, package, models, d, tmp_path / "base.txt")
    assert e.value.code == 1 and not (tmp_path / "base.txt").exists()


# --------------------------------------------------------------------------- #
# The golden-score harness
# --------------------------------------------------------------------------- #


def _harness_fixture(tmp_path):
    """Samples, a baseline .npz and a golden CSV computed by the port itself
    (tests/test_harness.py's fixture): per-song FAD of each sample and the
    whole set as 'samples/all'."""
    from fadtk_tpu_torch.metric.frechet import frechet_distance
    from fadtk_tpu_torch.metric.stats import calc_embd_statistics
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    samples = _make_dataset(tmp_path / "samples", 3, seed=4)
    base = _make_dataset(tmp_path / "base", 4, seed=5)
    fad = FrechetAudioDistance(variant(None))
    for d in (samples, base):
        for f in sorted(d.glob("*.wav")):
            fad.cache_embedding_file(f)
    mu, cov = fad.load_stats(base)
    npz = tmp_path / "baseline.npz"
    np.savez(npz, **{"tiny-speech.mu": mu, "tiny-speech.cov": cov})
    per_song = {}
    for f in sorted(samples.glob("*.wav")):
        per_song[f"samples/{f.stem}"] = frechet_distance(
            mu, cov, *calc_embd_statistics(fad.read_embedding_file(f)))
    per_song["samples/all"] = fad.score(npz, samples)
    golden = tmp_path / "golden.csv"
    golden.write_text("song_id,dataset,FAD_tiny_speech_fma_pop\n"
                      + "".join(f"{k},test,{v}\n" for k, v in per_song.items()))
    return samples, npz, golden


def _harness(tmp_path, monkeypatch, samples, npz, golden, out_name, models=None):
    from fadtk_tpu_torch.cli import test_harness

    monkeypatch.chdir(tmp_path)
    _cli(monkeypatch, test_harness, models or [variant(1), variant(None)],
         "--samples", samples, "--golden", golden, "--baseline", npz,
         "--out-dir", tmp_path / out_name, "--models", "tiny-speech")


def test_harness_exit_codes(tmp_path, monkeypatch):
    samples, npz, golden = _harness_fixture(tmp_path)
    _harness(tmp_path, monkeypatch, samples, npz, golden, "scores1")  # exit 0: returns
    rows = (tmp_path / "scores1" / "tiny-speech.csv").read_text().strip().split("\n")
    assert len(rows) == 4 and rows[-1].startswith("/samples/all,")
    comparison = (tmp_path / "comparison.csv").read_text().strip().split("\n")
    assert comparison[0] == "model,mse,max_abs_diff,mean,mad%,passed"
    assert comparison[1].startswith("tiny_speech,") and comparison[1].endswith(",True")

    lines = golden.read_text().strip().split("\n")
    bad = [lines[0]] + [",".join([*r.split(",")[:-1], str(float(r.split(",")[-1]) * 2 + 10)])
                        for r in lines[1:]]
    golden.write_text("\n".join(bad))
    with pytest.raises(SystemExit) as e:
        _harness(tmp_path, monkeypatch, samples, npz, golden, "scores2")
    assert e.value.code == 2


def test_harness_error_and_skip(tmp_path, monkeypatch):
    samples, npz, golden = _harness_fixture(tmp_path)
    (samples / "broken.wav").write_bytes(b"not a wav")
    with pytest.raises(SystemExit) as e:
        _harness(tmp_path, monkeypatch, samples, npz, golden, "scores3")
    assert e.value.code == 1

    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "0")
    _harness(tmp_path, monkeypatch, samples, npz, golden, "scores4")  # SKIPPED: no exit
    assert not (tmp_path / "scores4" / "tiny-speech.csv").exists()


def test_harness_reads_golden_like_jax(tmp_path):
    from fadtk_tpu.cli.test_harness import _read_golden as jax_read

    from fadtk_tpu_torch.cli.test_harness import _read_golden

    p = tmp_path / "g.csv"
    p.write_text("song_id,dataset,FAD_vggish_fma_pop,FAD_MERT_v1_95M_4_fma_pop\n"
                 "samples/a,x,1.5,2.5\nsamples/all,x,3.0,4.0\n")
    assert _read_golden(p) == jax_read(p)


# --------------------------------------------------------------------------- #
# Facades
# --------------------------------------------------------------------------- #

FACADES = ["fad", "fad_batch", "model_loader"]


def test_package_all_covers_jax():
    import fadtk_tpu

    import fadtk_tpu_torch

    assert set(fadtk_tpu.__all__) <= set(fadtk_tpu_torch.__all__)
    for name in fadtk_tpu_torch.__all__:
        assert hasattr(fadtk_tpu_torch, name), name
    assert fadtk_tpu_torch.ModelLoader is fadtk_tpu_torch.EmbeddingModel
    assert fadtk_tpu_torch.CLAPModel is fadtk_tpu_torch.MSCLAPModel
    assert fadtk_tpu_torch.find_sox_formats() == fadtk_tpu.find_sox_formats() == []


@pytest.mark.parametrize("module", FACADES)
def test_reference_submodules(module):
    import importlib

    jax_mod = importlib.import_module(f"fadtk_tpu.{module}")
    mod = importlib.import_module(f"fadtk_tpu_torch.{module}")
    assert mod.__all__ == jax_mod.__all__
    for name in mod.__all__:
        assert hasattr(mod, name), name


def test_facades_import_no_jax():
    code = ("import sys, runpy; import fadtk_tpu_torch, fadtk_tpu_torch.fad, "
            "fadtk_tpu_torch.fad_batch, fadtk_tpu_torch.model_loader, fadtk_tpu_torch.embeds, "
            "fadtk_tpu_torch.package, fadtk_tpu_torch.test.__main__, "
            "fadtk_tpu_torch.cli.test_harness; "
            "from fadtk_tpu_torch.utils import calculate_embd_statistics_online; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fadtk_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["embeds", "package", "test"])
def test_module_entry_points_parse(module):
    """``python -m fadtk_tpu_torch.<module> --help`` parses, like the JAX
    package's (reference module paths fadtk.embeds, fadtk.package,
    fadtk.test)."""
    r = subprocess.run([sys.executable, "-m", f"fadtk_tpu_torch.{module}", "--help"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "usage: python -m fadtk_tpu_torch" in r.stdout, r.stderr
