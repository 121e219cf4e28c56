"""The port's FAD-inf and per-song scoring against fadtk_tpu's on the CPU.

Host float64 modes (``score_inf``, ``score_individual``): the same numpy and
scipy arithmetic in both packages, held within 1e-9 relative. Device modes
(``metric/device_scoring.py``) run in float32 on the CPU here: per-song
scores within 1e-3 relative of the JAX package's device path and 2e-2 of the
host float64 ones (tests/test_device_scoring.py's bound; near-zero scores
guarded by max(|host|, 1e-6)); the trace step on given rows within 1e-3 of
host float64 in both of its branches. The device FAD-inf draws cannot equal
``jax.random``'s, so it is held to tests/test_device_scoring.py's statistical
checks. The dp = 2 cases run in two gloo processes (torch and
``fadtk_tpu_torch`` only).
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_tp import run_gloo

from fadtk_tpu_torch.metric import device_scoring as ds
from fadtk_tpu_torch.metric.frechet import FrechetBaseline, frechet_distance
from fadtk_tpu_torch.metric.stats import (
    calc_embd_statistics,
    welford_finalize,
    welford_init,
    welford_update,
)

HOST_RTOL = 1e-9
DEVICE_VS_JAX = 1e-3
DEVICE_VS_HOST = 2e-2


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)


def _frames(rng, n, d, shift=0.0):
    return (rng.standard_normal((n, d)) + shift).astype(np.float16)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-6)


def _fads(model_name="vggish"):
    """(JAX FrechetAudioDistance, port FrechetAudioDistance) for one registry
    name, models not loaded (the scores read caches only)."""
    from fadtk_tpu.models.registry import get_model as jax_model
    from fadtk_tpu.runner.fad import FrechetAudioDistance as JaxFAD

    from fadtk_tpu_torch.models.registry import get_model
    from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

    return (JaxFAD(jax_model(model_name), load_model=False),
            FrechetAudioDistance(get_model(model_name), load_model=False))


def _baseline_npz(tmp_path, rng, d, name="vggish"):
    base = _frames(rng, 3000, d).astype(np.float64)
    mu, cov = calc_embd_statistics(base)
    path = tmp_path / "base.npz"
    np.savez(path, **{f"{name}.mu": mu, f"{name}.cov": cov})
    return path, mu, cov


def _dataset(root: Path, lengths, d, seed, model="vggish", shift=0.4):
    """A dataset directory of placeholder audio files whose embeddings are
    already cached (``embeddings/<model>/<stem>.npy``, float16)."""
    rng = np.random.default_rng(seed)
    (root / "embeddings" / model).mkdir(parents=True)
    for i, n in enumerate(lengths):
        name = f"s{i:02d},x" if i == 1 else f"s{i:02d}"  # a comma the CSV sanitises
        (root / f"{name}.wav").write_bytes(b"")
        np.save(root / "embeddings" / model / f"{name}.npy", _frames(rng, n, d, shift))
    return root


# --------------------------------------------------------------------------- #
# Host float64 modes against the JAX package
# --------------------------------------------------------------------------- #


def test_score_inf_host_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    d = 16
    base, _, _ = _baseline_npz(tmp_path, rng, d)
    files = []
    for i, n in enumerate((400, 250, 350)):
        files.append(tmp_path / f"e{i}.npy")
        np.save(files[-1], _frames(rng, n, d, 0.3))
    jax_fad, fad = _fads()
    want = jax_fad.score_inf(base, files, steps=10, min_n=100, seed=5)
    got = fad.score_inf(base, files, steps=10, min_n=100, seed=5)
    assert type(got).__name__ == "FADInfResults" and got._fields == want._fields
    assert [n for n, _ in got.points] == [n for n, _ in want.points]
    for (_, g), (_, w) in zip(got.points, want.points, strict=True):
        assert _rel(g, w) <= HOST_RTOL
    for g, w in zip(got[:3], want[:3]):
        assert _rel(g, w) <= HOST_RTOL, (got, want)
    other = fad.score_inf(base, files, steps=10, min_n=100, seed=6)
    assert other.points != got.points  # the seed draws the subsamples


def test_score_individual_host_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    d = 16
    base, _, _ = _baseline_npz(tmp_path, rng, d)
    ev = _dataset(tmp_path / "e", (120, 40, 1, 300, 75), d, seed=2)  # s02: 1 frame, dropped
    jax_fad, fad = _fads()
    want = jax_fad.score_individual(base, ev, tmp_path / "jax.csv").read_text().split("\n")
    got = fad.score_individual(base, ev, tmp_path / "torch.csv").read_text().split("\n")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want, strict=True):
        (gf, gs), (wf, ws) = g.split(","), w.split(",")
        assert gf == wf and _rel(float(gs), float(ws)) <= HOST_RTOL
    assert got[0].count(",") == 1 and any("s01_x.wav" in row for row in got)
    scores = [abs(float(r.split(",")[1])) for r in got]
    assert scores == sorted(scores)

    # A str name goes under data/fad-individual/<cache_name>/, and an
    # existing CSV is left as it is.
    monkeypatch.chdir(tmp_path)
    path = fad.score_individual(base, ev, "named.csv")
    assert path == Path("data") / "fad-individual" / "vggish" / "named.csv"
    path.write_text("kept")
    assert fad.score_individual(base, ev, "named.csv").read_text() == "kept"


# --------------------------------------------------------------------------- #
# Device modes
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("d,lengths,bucket", [
    (32, (2, 5, 17, 3, 24), 8),  # pad 24 <= D: the (L, L) Gram; rank-deficient songs
    (24, (2, 60, 130, 90, 200), 128),  # pad 256 > D: the (D, D) side
])
def test_per_song_batch_matches_jax_and_host(d, lengths, bucket):
    from fadtk_tpu.metric.device_scoring import PerSongScorer as JaxScorer

    rng = np.random.default_rng(3)
    mu1, cov1 = calc_embd_statistics(_frames(rng, 3000, d).astype(np.float64))
    songs = [_frames(rng, n, d, 0.5) for n in lengths]
    got = ds.PerSongScorer(mu1, cov1, batch_size=2, len_bucket=bucket).score_batch(songs)
    want = JaxScorer(mu1, cov1, batch_size=2, len_bucket=bucket).score_batch(songs)
    assert np.isfinite(got).all()
    for i, song in enumerate(songs):
        host = frechet_distance(mu1, cov1, *calc_embd_statistics(song), method="eigh")
        assert _rel(got[i], want[i]) < DEVICE_VS_JAX, (i, got[i], want[i])
        assert _rel(got[i], host) < DEVICE_VS_HOST, (i, got[i], host)
    assert np.array_equal(ds.per_song_fad_device(mu1, cov1, songs, batch_size=2),
                          ds.PerSongScorer(mu1, cov1, batch_size=2).score_batch(songs))


def _trace_step_vs_host(mu1, cov1, sub):
    """(device step, host float64 FAD) of the rows ``sub``."""
    n, d = sub.shape
    host = FrechetBaseline(mu1, cov1).distance(*calc_embd_statistics(sub.astype(np.float64)))
    mu1_t, s1, tr1 = ds._baseline(mu1, cov1, torch.device("cpu"))
    st = welford_update(welford_init(d), torch.from_numpy(sub).float())
    return float(ds._fad_trace_step(mu1_t, s1, tr1, n, d, *welford_finalize(st))), host


@pytest.mark.parametrize("n", [10, 40, 200])  # below d (rank n - 1), below and above 4d
def test_trace_step_matches_host(n):
    rng = np.random.default_rng(4)
    d = 16
    mu1, cov1 = calc_embd_statistics(_frames(rng, 2000, d).astype(np.float64))
    embeds = _frames(rng, 1000, d, 0.3)
    got, host = _trace_step_vs_host(mu1, cov1, embeds[rng.choice(len(embeds), size=n)])
    assert _rel(got, host) < 1e-3, (got, host)


def test_trace_step_ill_conditioned_baseline():
    """A baseline whose spectrum spans 11 decades, as real embedding
    covariances can: the product s1 C2 s1 is then too ill-conditioned for the
    JAX package's 30 Newton-Schulz iterations at n >= 4d (their trace misses
    the exact one by more than 1e-3), and the port's exact trace still
    matches the host."""
    from fadtk_tpu_torch.metric.frechet import _ns_sqrt_sym

    rng = np.random.default_rng(8)
    d = 32
    u = np.linalg.qr(rng.standard_normal((d, d)))[0]
    cov1 = (u * np.logspace(-9, 2, d)) @ u.T
    mu1 = rng.standard_normal(d) * 0.1
    sub = (rng.standard_normal((400, d)) @ u.T * np.sqrt(np.logspace(-6, 1, d))).astype(
        np.float16)
    got, host = _trace_step_vs_host(mu1, cov1, sub)
    assert _rel(got, host) < 1e-3, (got, host)

    _, s1, _ = ds._baseline(mu1, cov1, torch.device("cpu"))
    cov2 = torch.from_numpy(np.cov(sub.astype(np.float32), rowvar=False)).float()
    m = s1 @ cov2 @ s1
    m = (m + m.T) * 0.5
    exact = float(torch.linalg.eigvalsh(m).clamp(min=0).sqrt().sum())
    ns = float(torch.trace(_ns_sqrt_sym(m, 30)))
    assert not abs(ns - exact) <= 1e-3 * exact, (ns, exact)


def test_fad_inf_device_reasonable_and_seeded():
    rng = np.random.default_rng(1)
    d = 32
    mu1, cov1 = calc_embd_statistics(_frames(rng, 5000, d).astype(np.float64))
    evals = _frames(rng, 3000, d, shift=0.3)
    score, slope, r2, points = ds.fad_inf_device(mu1, cov1, evals, steps=8, min_n=300, seed=0)
    assert [n for n, _ in points] == [int(n) for n in np.linspace(300, 3000, 8)]
    assert np.isfinite([score, slope]).all() and r2 > 0.5
    full = frechet_distance(mu1, cov1, *calc_embd_statistics(evals), method="eigh")
    assert abs(score - full) / full < 0.25
    # seeded, and float16 frames equal their float32 upcast
    again = ds.fad_inf_device(mu1, cov1, evals.astype(np.float32), steps=8, min_n=300, seed=0)
    assert again == (score, slope, r2, points)
    assert ds.fad_inf_device(mu1, cov1, evals, steps=8, min_n=300, seed=1)[3] != points


def test_dp_quota_split_matches_jax():
    from fadtk_tpu.metric.device_scoring import _dp_quota_split as jax_split

    rng = np.random.default_rng(5)
    for _ in range(50):
        dp = int(rng.integers(2, 9))
        nl = int(rng.integers(1, 400))
        n_total = int(rng.integers(1, dp * nl + 1))
        valid = np.clip(n_total - nl * np.arange(dp), 0, nl).astype(np.int32)
        ns = rng.integers(1, n_total + 1, size=12).astype(np.int32)
        got = ds._dp_quota_split(ns, valid)
        np.testing.assert_array_equal(got, jax_split(ns, valid))
        assert got.dtype == np.int32 and (got.sum(axis=1) == ns).all()
        assert (got <= valid[None, :]).all()


DP_WORKER = r"""
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.metric.device_scoring import PerSongScorer, fad_inf_device
from fadtk_tpu_torch.parallel.mesh import make_mesh

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
z = np.load(work / "inputs.npz")
songs = [z[f"song{i}"] for i in range(int(z["n_songs"]))]
mesh = make_mesh()
assert (mesh.dp, mesh.tp, mesh.dp_rank) == (world, 1, rank), mesh
per_song = PerSongScorer(z["mu"], z["cov"], batch_size=2, len_bucket=16, mesh=mesh).score_batch(
    songs)
a = fad_inf_device(z["mu"], z["cov"], z["evals"], steps=8, min_n=300, seed=7, mesh=mesh)
b = fad_inf_device(z["mu"], z["cov"], z["evals"], steps=8, min_n=300, seed=7, mesh=mesh)
np.savez(work / f"rank{rank}.npz", per_song=per_song, a=np.asarray(a[:3]),
         a_points=np.asarray(a[3]), b=np.asarray(b[:3]), b_points=np.asarray(b[3]))
dist.destroy_process_group()
"""


def test_dp2_sharded_scoring(tmp_path):
    """dp = 2 over gloo: per-song scores equal a single device's at batch 2 x
    2 exactly, on every rank; the sharded sweep is seed-reproducible, equal
    on both ranks, and passes the single-device sweep's statistical checks."""
    rng = np.random.default_rng(6)
    d = 32
    mu1, cov1 = calc_embd_statistics(_frames(rng, 5000, d).astype(np.float64))
    evals = _frames(rng, 3001, d, shift=0.3)  # not a multiple of dp
    songs = [_frames(rng, int(n), d, 0.4) for n in rng.integers(2, 40, size=11)]
    np.savez(tmp_path / "inputs.npz", mu=mu1, cov=cov1, evals=evals, n_songs=len(songs),
             **{f"song{i}": s for i, s in enumerate(songs)})
    run_gloo(DP_WORKER, tmp_path, world=2)

    single = ds.PerSongScorer(mu1, cov1, batch_size=4, len_bucket=16).score_batch(songs)
    full = frechet_distance(mu1, cov1, *calc_embd_statistics(evals), method="eigh")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for z in ranks:
        np.testing.assert_array_equal(z["per_song"], single)
        np.testing.assert_array_equal(z["a"], z["b"])
        np.testing.assert_array_equal(z["a_points"], z["b_points"])
        np.testing.assert_array_equal(z["a"], ranks[0]["a"])
        score, _, r2 = z["a"]
        assert r2 > 0.5 and abs(score - full) / full < 0.25, (score, full, r2)
    assert [int(n) for n in ranks[0]["a_points"][:, 0]] == [
        int(n) for n in np.linspace(300, 3001, 8)]


# --------------------------------------------------------------------------- #
# The CLI against fadtk_tpu's
# --------------------------------------------------------------------------- #


@pytest.fixture
def cli_data(tmp_path):
    """Two cached datasets (d = 16), copied for each package's run."""
    src = tmp_path / "src"
    _dataset(src / "b", (300, 250, 320), 16, seed=7, shift=0.0)
    _dataset(src / "e", (90, 140, 70, 120, 110, 80), 16, seed=8)
    for pkg in ("jax", "torch"):
        shutil.copytree(src, tmp_path / pkg)
    return tmp_path


def _run_cli(monkeypatch, pkg, root, *flags):
    if pkg == "jax":
        from fadtk_tpu.cli.main import main
    else:
        from fadtk_tpu_torch.cli.main import main
    monkeypatch.setattr(sys, "argv", ["fadtk", "vggish", str(root / pkg / "b"),
                                      str(root / pkg / "e"), *flags])
    main()


def test_cli_inf_matches_jax(cli_data, monkeypatch, capsys):
    rows = {}
    for pkg in ("jax", "torch"):
        csv = cli_data / f"{pkg}.csv"
        _run_cli(monkeypatch, pkg, cli_data, str(csv), "--inf", "--seed", "3")
        assert "FAD-inf Information: FADInfResults(score=" in capsys.readouterr().out
        lines = csv.read_text().strip().split("\n")
        assert lines[0] == "model,baseline,eval,score,inf_r2,time" and len(lines) == 2
        rows[pkg] = lines[1].split(",")
    got, want = rows["torch"], rows["jax"]
    assert got[0] == want[0] == "vggish"
    assert got[1].endswith("torch/b") and want[1].endswith("jax/b")
    for i in (3, 4):  # score, inf_r2
        assert _rel(float(got[i]), float(want[i])) <= HOST_RTOL, (got, want)


def test_cli_indiv_matches_jax(cli_data, monkeypatch):
    out = {}
    for pkg in ("jax", "torch"):
        csv = cli_data / f"{pkg}-indiv.csv"
        with pytest.raises(SystemExit) as exit_info:
            _run_cli(monkeypatch, pkg, cli_data, str(csv), "--indiv")
        assert exit_info.value.code == 0
        out[pkg] = [row.split(",") for row in csv.read_text().split("\n")]
    assert len(out["torch"]) == len(out["jax"]) == 6
    for (gf, gs), (wf, ws) in zip(out["torch"], out["jax"], strict=True):
        assert Path(gf).name == Path(wf).name and _rel(float(gs), float(ws)) <= HOST_RTOL


def test_cli_device_scoring_close_to_host(cli_data, monkeypatch, capsys):
    """``--device-scoring`` through the port's CLI (float32 on the CPU here):
    per-song rows in the host's order within 2e-2, and a finite FAD-inf row."""
    host = cli_data / "host.csv"
    dev = cli_data / "device.csv"
    for csv, flags in ((host, ()), (dev, ("--device-scoring",))):
        with pytest.raises(SystemExit):
            _run_cli(monkeypatch, "torch", cli_data, str(csv), "--indiv", *flags)
    want = [row.split(",") for row in host.read_text().split("\n")]
    got = dict(row.split(",") for row in dev.read_text().split("\n"))
    assert set(got) == {f for f, _ in want}
    for f, s in want:
        assert _rel(float(got[f]), float(s)) < DEVICE_VS_HOST

    csv = cli_data / "inf.csv"
    _run_cli(monkeypatch, "torch", cli_data, str(csv), "--inf", "--device-scoring")
    assert "FAD-inf Information:" in capsys.readouterr().out
    row = csv.read_text().strip().split("\n")[1].split(",")
    assert np.isfinite(float(row[3])) and np.isfinite(float(row[4]))


def test_cli_devices_needs_a_mode(cli_data, monkeypatch):
    with pytest.raises(SystemExit, match="--tp/--devices require --device-pipeline"):
        _run_cli(monkeypatch, "torch", cli_data, "--devices", "2")
    with pytest.raises(SystemExit, match="torchrun"):
        _run_cli(monkeypatch, "torch", cli_data, "--inf", "--device-scoring", "--devices", "2")


def test_cli_device_scoring_under_torchrun(cli_data, monkeypatch):
    """``--device-scoring --devices 2`` under torchrun (two gloo processes on
    the CPU): rank 0 alone writes the CSVs; the per-song rows equal the
    single-process device run's, and the FAD-inf row is finite."""
    import os
    import subprocess

    single = cli_data / "single.csv"
    with pytest.raises(SystemExit):
        _run_cli(monkeypatch, "torch", cli_data, str(single), "--indiv", "--device-scoring")
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1]),
           "FADTK_TPU_TORCH_DEVICE": "cpu"}
    root = cli_data / "torch"
    for csv, mode in (("dp2.csv", "--indiv"), ("dp2-inf.csv", "--inf")):
        subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "fadtk_tpu_torch", "vggish", str(root / "b"), str(root / "e"),
             str(cli_data / csv), mode, "--device-scoring", "--devices", "2"],
            env=env, check=True, timeout=240, capture_output=True)
    assert (cli_data / "dp2.csv").read_text() == single.read_text()
    rows = (cli_data / "dp2-inf.csv").read_text().strip().split("\n")
    assert len(rows) == 2 and np.isfinite([float(x) for x in rows[1].split(",")[3:5]]).all()

