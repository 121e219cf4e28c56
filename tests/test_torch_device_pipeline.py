"""The port's device pipeline (``--device-pipeline``) on the CPU.

- ``dataset_stats_device`` against the port's cached-embedding path (itself
  held against the JAX package by tests/test_torch_pipeline.py) on a small
  ragged dataset, in one process and at (dp, tp) = (1, 2) over gloo: n exact,
  mu within 1e-3 and cov within 5e-3 (tests/test_device_pipeline.py's bounds:
  float32 accumulation against the cached path's float64 per-file merge);
- crash-resume: a run interrupted after its first checkpoint resumes to
  statistics bit-identical to an uninterrupted run, and checkpoints written
  by either package open in the other;
- the in-memory clip loader equals the cached path's ``load_audio``;
- the CLI flags.

The model is a narrow speech encoder (seven convs of width 16 with the
published kernels and strides, hidden 64, 4 heads, 2 layers) at 8 kHz, so a
10 s bucket is 249 frames; random weights from seed 0.
"""

import os
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel
from fadtk_tpu_torch.runner import convert
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device
from fadtk_tpu_torch.runner.resume import StatsCheckpoint, open_checkpoint, pipeline_ckpt_path

from test_torch_tp import run_gloo

SR = 8000
CFG = SpeechEncoderConfig(
    conv_dim=(16,) * 7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_normalize=True,
)
MU_ATOL, COV_ATOL = 1e-3, 5e-3


def tiny_model():
    return SpeechEmbeddingModel("tiny-speech", 64, SR, CFG, 2, "test/tiny-speech")


def _make_dataset(d: Path, n: int, seed: int) -> Path:
    """n ragged clips of 0.3-1.2 s: mostly at 8 kHz, one at 44.1 kHz and one
    at 16 kHz, so the host resampler runs for misses."""
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        sr = {1: 44100, 3: 16000}.get(i, SR)
        t = np.arange(int(sr * rng.uniform(0.3, 1.2))) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 1500) * t) + 0.05 * rng.standard_normal(t.size)
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "no-checkpoints"))
    monkeypatch.setenv("FADTK_TPU_BF16", "")  # set, so the CLI's writes are undone
    monkeypatch.delenv("FADTK_TPU_CKPT", raising=False)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two datasets, and the cached path's statistics of the first, computed
    on a copy so the originals never see an embedding or convert cache."""
    from unittest import mock

    from fadtk_tpu_torch.runner.batch import cache_embedding_files
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    root = tmp_path_factory.mktemp("pipeline")
    base = _make_dataset(root / "base", 5, seed=0)
    other = _make_dataset(root / "other", 3, seed=1)
    shutil.copytree(base, root / "cached")
    env = {"FADTK_TPU_TORCH_DEVICE": "cpu", "FADTK_TPU_RANDOM_WEIGHTS": "1",
           "FADTK_TPU_CHECKPOINTS": str(root / "no-checkpoints")}
    with mock.patch.dict(os.environ, env):
        model = tiny_model()
        cache_embedding_files(root / "cached", model, workers=2)
        mu, cov = FrechetAudioDistance(model, load_model=False).load_stats(root / "cached")
    embs = sorted((root / "cached" / "embeddings" / "tiny-speech").glob("*.npy"))
    n = sum(np.load(f).shape[0] for f in embs)
    return {"root": root, "base": base, "other": other, "model": model,
            "cached": (mu, cov, n)}


def _no_caches(d: Path):
    assert not (d / "embeddings").exists() and not (d / "convert").exists()
    assert not (d / "stats" / "tiny-speech").exists()  # the checkpoint dir went too


@pytest.mark.parametrize("batch", [2, 16])
def test_stats_match_cached_path(data, batch):
    """batch 2 makes three steps, the last with a padded row; 16 one step."""
    mu, cov, n = dataset_stats_device(data["model"], data["base"], batch=batch, workers=2)
    mu_ref, cov_ref, n_ref = data["cached"]
    clips = convert.ClipLoader(data["model"], workers=1).iter_clips(
        sorted(data["base"].glob("*.wav")))
    assert n == n_ref == sum(CFG.num_output_frames(c.shape[0]) for c in clips)
    np.testing.assert_allclose(mu, mu_ref, atol=MU_ATOL, rtol=0)
    np.testing.assert_allclose(cov, cov_ref, atol=COV_ATOL, rtol=0)
    _no_caches(data["base"])


def test_stats_gap_is_the_cached_paths_float16_means(data):
    """The split of scripts/torch_pipeline_gap_probe.py at tiny width: the
    pipeline's frames equal the cached path's before and after the float16
    cast, its float32 accumulation is within float32 error of float64
    statistics of those frames, and what is left of the gap is the cached
    path's float16 per-file means (the reference's ``np.mean`` of a float16
    .npy), which the pipeline does not reproduce."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    from torch_pipeline_gap_probe import split_gap

    g = split_gap(data["model"], data["base"], batch=2)
    assert g["n"] == data["cached"][2]
    assert g["forward_rel"] <= 1e-6 and g["f16_flips"] <= 1e-4 * g["f16_values"]
    assert g["accum_mu"] <= 1e-6 and g["accum_cov"] <= 1e-5
    assert g["exact_mu"] <= 1e-6 and g["exact_cov"] <= 1e-5
    assert g["cached_host_mu"] > 10 * g["exact_mu"]
    assert g["total_mu"] <= g["cached_host_mu"] + g["exact_mu"]
    _no_caches(data["base"])


WORKER = r"""
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
cfg = SpeechEncoderConfig(
    conv_dim=(16,) * 7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_normalize=True)
model = SpeechEmbeddingModel("tiny-speech", 64, 8000, cfg, 2, "test/tiny-speech")
mesh = make_mesh(tp=2)
assert (mesh.dp, mesh.tp, mesh.tp_rank) == (1, 2, rank), mesh
mu, cov, n = dataset_stats_device(model, work / "base", mesh=mesh, batch=2, workers=1)
np.savez(work / f"rank{rank}.npz", mu=mu, cov=cov, n=n)
dist.destroy_process_group()
"""


def test_stats_match_cached_path_tp2_over_gloo(data, tmp_path, monkeypatch):
    """(dp, tp) = (1, 2) in two gloo processes: heads and FFN columns split,
    the same statistics on both ranks."""
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    shutil.copytree(data["base"], tmp_path / "base")
    run_gloo(WORKER, tmp_path, world=2)
    mu_ref, cov_ref, n_ref = data["cached"]
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        assert int(z["n"]) == n_ref
        np.testing.assert_allclose(z["mu"], mu_ref, atol=MU_ATOL, rtol=0)
        np.testing.assert_allclose(z["cov"], cov_ref, atol=COV_ATOL, rtol=0)
    _no_caches(tmp_path / "base")


def test_clip_loader_equals_cached_load_audio(data):
    """Hits read the convert cache, misses convert in memory; both equal the
    cached path's ``load_audio`` bit for bit, and misses write no cache."""
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    model = data["model"]
    files = sorted(data["base"].glob("*.wav"))
    got = list(convert.ClipLoader(model, workers=2).iter_clips(files))
    cached = data["root"] / "cached"
    fad = FrechetAudioDistance(model, load_model=False)
    for f, clip in zip(files, got):
        want = fad.load_audio(cached / f.name)
        assert clip.dtype == want.dtype and np.array_equal(clip, want)
    _no_caches(data["base"])
    hits = list(convert.ClipLoader(model, workers=1).iter_clips(sorted(cached.glob("*.wav"))))
    assert all(np.array_equal(a, b) for a, b in zip(hits, got))


def test_clip_loader_device_transport_is_not_ported(data, monkeypatch):
    """The device transport is ported now (tests/test_torch_convert_transport.py
    holds it against the JAX package's): it builds on the model's device, and
    an unknown transport still raises."""
    monkeypatch.setenv("FADTK_TPU_CONVERT_TRANSPORT", "device")
    loader = convert.ClipLoader(data["model"])
    assert loader.transport == "device" and loader.device == data["model"].device
    monkeypatch.setenv("FADTK_TPU_CONVERT_TRANSPORT", "disk")
    with pytest.raises(ValueError, match="must be"):
        convert.ClipLoader(data["model"])


class _CrashAfter:
    """Iterator wrapper that dies, like a preemption, after ``n`` items."""

    class Crash(RuntimeError):
        pass

    def __init__(self, it, n):
        self.it, self.n = iter(it), n

    def __iter__(self):
        return self

    def __next__(self):
        if self.n == 0:
            raise self.Crash()
        self.n -= 1
        return next(self.it)


def test_resume_bit_identical(data, monkeypatch):
    """Checkpoints land on batch = file boundaries, so a run interrupted
    after its first checkpoint resumes to bit-identical statistics; success
    deletes the checkpoint (tests/test_pipeline_resume.py's pattern)."""
    model, d = data["model"], data["base"]
    monkeypatch.setenv("FADTK_TPU_CKPT", "0")
    mu_ref, cov_ref, n_ref = dataset_stats_device(model, d, batch=2, workers=1)
    monkeypatch.delenv("FADTK_TPU_CKPT")
    monkeypatch.setenv("FADTK_TPU_CKPT_FILES", "1")
    monkeypatch.setenv("FADTK_TPU_CKPT_SECONDS", "0")
    ckpt_path = pipeline_ckpt_path(d, model)
    orig = convert.ClipLoader.iter_clips
    with monkeypatch.context() as m:
        m.setattr(convert.ClipLoader, "iter_clips",
                  lambda self, files: _CrashAfter(orig(self, files), 3))
        with pytest.raises(_CrashAfter.Crash):
            dataset_stats_device(model, d, batch=2, workers=1)
    assert ckpt_path.exists(), "a crash leaves the checkpoint behind"
    fp = StatsCheckpoint.fingerprint_of(model, sorted(d.glob("*.*")))
    assert StatsCheckpoint(ckpt_path, fp).load()[1] == 2  # the first batch's two files

    seen = []
    with monkeypatch.context() as m:
        m.setattr(convert.ClipLoader, "iter_clips",
                  lambda self, files: seen.extend(files) or orig(self, files))
        mu, cov, n = dataset_stats_device(model, d, batch=2, workers=1)
    assert [f.name for f in seen] == ["c2.wav", "c3.wav", "c4.wav"]  # resumed at file 2
    assert not ckpt_path.exists(), "success deletes the checkpoint"
    assert n == n_ref
    np.testing.assert_array_equal(mu, mu_ref)
    np.testing.assert_array_equal(cov, cov_ref)
    _no_caches(d)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """The fingerprint, npz layout and knobs are the JAX package's: a
    checkpoint written by either package resumes in the other."""
    from fadtk_tpu.runner import resume as jresume

    from fadtk_tpu_torch.runner import resume as tresume

    model = SimpleNamespace(cache_name="w2v2-base-bf16", num_features=768)
    files = [tmp_path / f"c{i}.wav" for i in range(5)]
    path = tmp_path / "stats" / "w2v2-base-bf16" / "pipeline_ckpt.npz"
    rng = np.random.default_rng(0)
    state = (rng.standard_normal(768).astype(np.float32),
             rng.standard_normal((768, 768)).astype(np.float32), np.float32(1234.0))
    fp_j = jresume.StatsCheckpoint.fingerprint_of(model, files)
    assert tresume.StatsCheckpoint.fingerprint_of(model, files) == fp_j
    src, dst = (jresume, tresume) if writer == "jax" else (tresume, jresume)
    src.StatsCheckpoint(path, fp_j).save(state, 3)
    ckpt, loaded, done = dst.open_checkpoint(path, model, files)
    assert done == 3 and ckpt is not None
    for a, b in zip(loaded, state):
        np.testing.assert_array_equal(a, b)
    # Another file list (or order) is another pass: ignored.
    assert dst.open_checkpoint(path, model, files[::-1])[1:] == (None, 0)
    ckpt.finalize()
    assert not path.exists() and not path.parent.exists()


def test_open_checkpoint_disabled(tmp_path, monkeypatch):
    model = SimpleNamespace(cache_name="m", num_features=4)
    assert open_checkpoint(None, model, []) == (None, None, 0)
    monkeypatch.setenv("FADTK_TPU_CKPT", "0")
    assert open_checkpoint(tmp_path / "c.npz", model, []) == (None, None, 0)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def _cli(monkeypatch, *argv):
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.models.registry import get_model

    monkeypatch.setattr(cli, "get_all_models", lambda: [tiny_model(), get_model("vggish")])
    monkeypatch.setattr(sys, "argv", ["fadtk", *map(str, argv)])
    cli.main()


def test_cli_device_pipeline_writes_the_csv_row(data, tmp_path, monkeypatch):
    from fadtk_tpu_torch.metric.frechet import frechet_distance

    base, other = data["base"], data["other"]
    csv = tmp_path / "scores.csv"
    _cli(monkeypatch, "tiny-speech", base, other, csv, "--device-pipeline", "--batch", "4")
    rows = csv.read_text().strip().split("\n")
    assert rows[0] == "model,baseline,eval,score,inf_r2,time" and len(rows) == 2
    fields = rows[1].split(",")
    assert fields[:3] == ["tiny-speech", str(base), str(other)] and fields[4] == "None"
    mu1, cov1, _ = dataset_stats_device(data["model"], base, batch=4, workers=1)
    mu2, cov2, _ = dataset_stats_device(data["model"], other, batch=4, workers=1)
    assert float(fields[3]) == frechet_distance(mu1, cov1, mu2, cov2)
    _no_caches(base)
    _no_caches(other)


@pytest.mark.parametrize("argv,message", [
    (("tiny-speech", "--inf", "--device-pipeline"), "supports plain scoring only"),
    (("tiny-speech", "--indiv", "--device-pipeline"), "supports plain scoring only"),
    (("tiny-speech", "--tp", "2"), "require --device-pipeline"),
    (("tiny-speech", "--devices", "2"), "require --device-pipeline"),
    (("tiny-speech", "--device-pipeline", "--tp", "2"), "torchrun"),
    (("vggish", "--device-pipeline", "--devices", "2"), "torchrun"),
    (("tiny-speech", "--multihost"), "--multihost requires --device-pipeline"),
])
def test_cli_exits_with_message(data, monkeypatch, argv, message):
    model, *flags = argv
    with pytest.raises(SystemExit, match=message):
        _cli(monkeypatch, model, data["base"], data["other"], *flags)
    _no_caches(data["base"])
