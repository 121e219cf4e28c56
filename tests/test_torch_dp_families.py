"""The port's chunked and whole-clip device pipeline (``parallel/dp.py``,
``--device-pipeline`` for the non-speech families) on the CPU.

- ``dataset_stats_device`` against the port's cached-embedding path (itself
  held against the JAX package by each family's test file) for vggish,
  encodec-emb-48k (1 s segments and the exact-length tail), encodec-emb (whole
  clips grouped by length), cdpam-acoustic, dac-44kHz, whisper-tiny and
  clap-laion-audio, with tests/test_dp_families.py's bounds (float32
  accumulation of the same float16-rounded frames against the host's
  float64 merge);
- batch-size invariance; dp = 2 over gloo against one process (n exact, mu
  within 1e-5), where every rank must count each 48k tail once;
- cdpam-acoustic's pipeline statistics against the JAX package's
  ``dataset_stats_device`` with the same weights;
- crash-resume, and the CLI's ``--device-pipeline`` on a non-speech model.

CPU time: EnCodec (``num_filters`` 8), DAC (``d_model`` 8) and CLAP (a
two-stage HTSAT of width 8, tests/test_torch_clap.py's ``SMALL64``) run
narrow, at their published windows, segments, frontends and feature widths;
the rest at published width. Random weights from seed 0.
"""

import shutil
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16
from fadtk_tpu_torch.runner import convert
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device
from fadtk_tpu_torch.runner.resume import pipeline_ckpt_path

from test_torch_tp import run_gloo


def narrow(name: str):
    """The registry's model, narrowed where its published width is slow on
    the CPU (see the module docstring)."""
    from fadtk_tpu_torch.models import htsat
    from fadtk_tpu_torch.models.registry import get_model

    m = get_model(name)
    if name.startswith("encodec-"):
        m.cfg = replace(m.cfg, num_filters=8)
    elif name == "dac-44kHz":
        m.cfg = replace(m.cfg, d_model=8)
    elif name.startswith("clap-"):
        m.cfg = htsat.HTSATConfig(spec_size=256, patch_size=4, patch_stride=4,
                                  num_mel_bins=64, window_size=8, depths=(1, 1),
                                  num_heads=(2, 2), embed_dim=8)
    return m


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the driver runs the suite in several processes
    at once, and EnCodec's LSTM slows by two orders of magnitude when each
    of them spins a full thread pool; alone this file takes about as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "no-checkpoints"))
    monkeypatch.setenv("FADTK_TPU_BF16", "")  # set, so the CLI's writes are undone
    monkeypatch.delenv("FADTK_TPU_CKPT", raising=False)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Four clips at 16 kHz (tests/test_dp_families.py's): 2.3 s gives ragged
    encodec-48k tails and cdpam chunks, 1.1 s the short-clip path."""
    d = tmp_path_factory.mktemp("dpds") / "data"
    d.mkdir()
    rng = np.random.default_rng(3)
    sr = 16000
    for i, sec in enumerate((2.3, 1.1, 2.0, 1.7)):
        t = np.arange(int(sr * sec)) / sr
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(200, 2000) * t)
        x += 0.05 * rng.standard_normal(t.shape[0])
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), sr)
    return d


def _cached_stats(model, d: Path, work: Path):
    """The cached path's (mu, cov) on a copy of ``d`` (so the original never
    holds a cache)."""
    from fadtk_tpu_torch.runner.batch import cache_embedding_files
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    copy = work / "cached"
    shutil.copytree(d, copy)
    cache_embedding_files(copy, model, workers=1)
    return FrechetAudioDistance(model, load_model=False).load_stats(copy)


def _no_caches(d: Path):
    assert not (d / "embeddings").exists() and not (d / "convert").exists()
    assert not (d / "stats").exists() or not any((d / "stats").iterdir())


def _assert_close_to_cached(mu, cov, mu_ref, cov_ref):
    """tests/test_dp_families.py's bounds: same float16-rounded frames, float32
    accumulation on the device against the host float64 merge; the
    covariance floor covers near-collinear L2-normalised embeddings."""
    scale = max(np.abs(mu_ref).max(), 1e-6)
    np.testing.assert_allclose(mu, mu_ref, atol=2e-3 * scale, rtol=2e-3)
    cscale = max(np.abs(cov_ref).max(), 1e-6)
    floor = 4e-7 * max(scale, 1.0) ** 2
    np.testing.assert_allclose(cov, cov_ref, atol=4e-3 * cscale + floor, rtol=4e-3)


FAMILIES = ["vggish", "encodec-emb-48k", "encodec-emb", "cdpam-acoustic", "dac-44kHz",
            "whisper-tiny", "clap-laion-audio"]


@pytest.mark.parametrize("name", FAMILIES)
def test_stats_match_cached_path(dataset, name, tmp_path):
    model = narrow(name)
    mu_ref, cov_ref = _cached_stats(model, dataset, tmp_path)
    embs = sorted((tmp_path / "cached" / "embeddings" / model.name).glob("*.npy"))
    n_ref = sum(np.load(f).shape[0] for f in embs)

    mu, cov, n = dataset_stats_device(model, dataset, batch=8, workers=1)
    assert n == n_ref >= 2
    _assert_close_to_cached(mu, cov, mu_ref, cov_ref)
    _no_caches(dataset)


def test_batch_size_invariance(dataset):
    """Chunk packing across files leaves the statistics as they are (exact
    Chan merges across batches): batch 4 packs the nine cdpam chunks into
    three batches, 12 into one."""
    model = narrow("cdpam-acoustic")
    mu_a, cov_a, n_a = dataset_stats_device(model, dataset, batch=4, workers=1)
    mu_b, cov_b, n_b = dataset_stats_device(model, dataset, batch=12, workers=1)
    assert n_a == n_b == 9
    np.testing.assert_allclose(mu_a, mu_b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cov_a, cov_b, rtol=1e-3, atol=1e-5)


def test_memoised_spec_serves_every_pass(dataset):
    from fadtk_tpu_torch.runner import device_pipeline as pipe

    model = narrow("vggish")
    model.ensure_loaded()
    spec = pipe._model_dp_specs(model)
    assert spec[0] is not None and spec[1] is None
    dataset_stats_device(model, dataset, batch=8, workers=1)
    assert pipe._model_dp_specs(model) is spec
    whole = narrow("encodec-emb")
    whole.ensure_loaded()
    assert pipe._model_dp_specs(whole)[0] is None and pipe._model_dp_specs(whole)[1] is not None


WORKER = r"""
import sys
from dataclasses import replace
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.models.registry import get_model
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
mesh = make_mesh()
assert (mesh.dp, mesh.tp, mesh.dp_rank) == (2, 1, rank), mesh
for name, batch in (("encodec-emb-48k", 4), ("encodec-emb", 2)):
    model = get_model(name)
    model.cfg = replace(model.cfg, num_filters=8)  # narrow(name)
    mu, cov, n = dataset_stats_device(model, work / "data", mesh=mesh, batch=batch, workers=1)
    np.savez(work / f"{name}-rank{rank}.npz", mu=mu, cov=cov, n=n)
dist.destroy_process_group()
"""


def test_dp2_over_gloo_equals_one_process(dataset, tmp_path):
    """dp = 2 in two gloo processes: each rank embeds half of every batch
    (an odd count of rows gets a weight-0 pad row) and one rank counts each
    clip's 48k tail, so n is exact and the merged statistics equal one
    process's on both ranks."""
    shutil.copytree(dataset, tmp_path / "data")
    run_gloo(WORKER, tmp_path, world=2)
    for name, batch in (("encodec-emb-48k", 4), ("encodec-emb", 2)):
        mu1, cov1, n1 = dataset_stats_device(narrow(name), dataset, batch=batch, workers=1)
        for r in range(2):
            z = np.load(tmp_path / f"{name}-rank{r}.npz")
            assert int(z["n"]) == n1
            np.testing.assert_allclose(z["mu"], mu1, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(z["cov"], cov1, rtol=1e-4, atol=1e-4)
    _no_caches(tmp_path / "data")


def test_cdpam_matches_jax_package_pipeline(dataset, tmp_path, monkeypatch):
    """cdpam-acoustic through both packages' ``dataset_stats_device`` on the
    CPU, the port loading the JAX package's stored random weights."""
    import jax

    from fadtk_tpu.models.cdpam_impl import init_cdpam_params
    from fadtk_tpu.models.registry import get_model as jax_model
    from fadtk_tpu.parallel.mesh import make_mesh as jax_mesh
    from fadtk_tpu.runner.device_pipeline import dataset_stats_device as jax_stats
    from fadtk_tpu.weights.store import save_params

    from fadtk_tpu_torch.models.registry import get_model

    save_params(init_cdpam_params(jax.random.PRNGKey(0)), tmp_path / "cdpam.npz")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path))
    monkeypatch.setenv("FADTK_TPU_CKPT", "0")
    mu_j, cov_j, n_j = jax_stats(jax_model("cdpam-acoustic"), dataset, mesh=jax_mesh(1),
                                 batch=8)
    mu, cov, n = dataset_stats_device(get_model("cdpam-acoustic"), dataset, batch=8, workers=1)
    assert n == n_j == 9
    _assert_close_to_cached(mu, cov, mu_j, cov_j)
    _no_caches(dataset)


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


@pytest.mark.parametrize("name", ["cdpam-acoustic", "encodec-emb"])
def test_resume_after_crash(dataset, tmp_path, monkeypatch, name):
    """A checkpoint after every file flushes the pending chunks (or buffered
    clip groups) first, so a run that dies after three clips resumes at file
    3 and ends within float32 accumulation of an uninterrupted run (the
    packing differs); success deletes the checkpoint."""
    d = tmp_path / "data"
    shutil.copytree(dataset, d)
    model = narrow(name)
    monkeypatch.setenv("FADTK_TPU_CKPT", "0")
    mu_ref, cov_ref, n_ref = dataset_stats_device(model, d, batch=8, workers=1)
    monkeypatch.delenv("FADTK_TPU_CKPT")
    monkeypatch.setenv("FADTK_TPU_CKPT_FILES", "1")
    monkeypatch.setenv("FADTK_TPU_CKPT_SECONDS", "1e9")
    ckpt_path = pipeline_ckpt_path(d, model)
    orig = convert.ClipLoader.iter_clips
    with monkeypatch.context() as m:
        m.setattr(convert.ClipLoader, "iter_clips",
                  lambda self, files: _CrashAfter(orig(self, files), 3))
        with pytest.raises(_CrashAfter.Crash):
            dataset_stats_device(model, d, batch=8, workers=1)
    assert ckpt_path.exists(), "a crash leaves the checkpoint behind"

    seen = []
    with monkeypatch.context() as m:
        m.setattr(convert.ClipLoader, "iter_clips",
                  lambda self, files: seen.extend(files) or orig(self, files))
        mu, cov, n = dataset_stats_device(model, d, batch=8, workers=1)
    assert [f.name for f in seen] == ["c3.wav"]  # resumed at file 3
    assert not ckpt_path.exists(), "success deletes the checkpoint"
    assert n == n_ref
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov, cov_ref, rtol=1e-4, atol=1e-6)
    _no_caches(d)


def test_cli_device_pipeline_non_speech(dataset, tmp_path, monkeypatch):
    """``python -m fadtk_tpu_torch vggish a b csv --device-pipeline``: the CSV
    row's score is the Frechet distance of the two pipeline passes."""
    from fadtk_tpu_torch.cli import main as cli
    from fadtk_tpu_torch.metric.frechet import frechet_distance

    other = tmp_path / "other"
    shutil.copytree(dataset, other)
    (other / "c0.wav").unlink()
    csv = tmp_path / "scores.csv"
    monkeypatch.setattr(cli, "get_all_models", lambda: [narrow("vggish")])
    monkeypatch.setattr(sys, "argv", ["fadtk", "vggish", str(dataset), str(other), str(csv),
                                      "--device-pipeline", "--batch", "4"])
    cli.main()
    rows = csv.read_text().strip().split("\n")
    assert rows[0] == "model,baseline,eval,score,inf_r2,time" and len(rows) == 2
    fields = rows[1].split(",")
    assert fields[:3] == ["vggish", str(dataset), str(other)] and fields[4] == "None"
    model = narrow("vggish")
    mu1, cov1, _ = dataset_stats_device(model, dataset, batch=4, workers=1)
    mu2, cov2, _ = dataset_stats_device(model, other, batch=4, workers=1)
    assert float(fields[3]) == frechet_distance(mu1, cov1, mu2, cov2)
    _no_caches(dataset)
    _no_caches(other)


def test_batch_must_divide_dp(dataset):
    from fadtk_tpu_torch.parallel.dp import dp_chunk_dataset_stats
    from fadtk_tpu_torch.parallel.mesh import Mesh

    import torch

    mesh = Mesh(dp=2, tp=1, dp_rank=0, tp_rank=0, device=torch.device("cpu"))
    model = narrow("cdpam-acoustic")
    model.ensure_loaded()
    with pytest.raises(ValueError, match="must divide dp=2"):
        dp_chunk_dataset_stats(model.dp_spec(), iter([]), mesh, batch=3)
