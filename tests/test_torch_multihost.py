"""The port's multi-node mode (``parallel/multihost.py``, ``--multihost``) on
the CPU; the counterparts of tests/test_multihost.py:

1. the (dp, tp) layout keeps every tp group on one node, over a simulated
   2 nodes x 4 processes;
2. a tp degree whose groups would cross nodes is refused;
3. ``initialize`` takes torchrun's environment or its explicit arguments;
4. a 4-process "2 nodes x 2" gloo job (127.0.0.1, joined with a timeout):
   ``initialize`` + ``global_mesh(tp=2)`` and the pipeline's dp merge of
   Welford partials, equal on every rank to the host statistics of all rows
   (mu and cov within 1e-6 / 1e-5), and tp=4 refused on every rank;
5. the CLI's ``--device-pipeline --multihost`` under ``torch.distributed.run``
   (one node, one and two processes), whose score equals the plain
   one-process run's within 1e-6 relative.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fadtk_tpu_torch.parallel import multihost
from fadtk_tpu_torch.parallel.mesh import tp_groups

REPO = Path(__file__).resolve().parents[1]
SCORE_RTOL = 1e-6


def test_tp_groups_stay_within_a_node():
    """2 nodes x 4 processes, ranks numbered node by node as torchrun does:
    every tp group of the mesh's layout lies on one node."""
    nodes = [r // 4 for r in range(8)]
    for tp in (1, 2, 4):
        multihost.check_tp_within_nodes(nodes, tp, local=4)
        groups = tp_groups(8, tp)
        assert len(groups) == 8 // tp
        for d, group in enumerate(groups):
            assert len({nodes[r] for r in group}) == 1
            # mesh.make_mesh's layout: rank r is (dp_rank r // tp, tp_rank r % tp)
            assert all(r // tp == d and r % tp == i for i, r in enumerate(group))


def test_tp_crossing_nodes_is_refused():
    nodes = [r // 4 for r in range(8)]
    with pytest.raises(ValueError, match="within one node"):
        multihost.check_tp_within_nodes(nodes, 8, local=4)
    with pytest.raises(ValueError, match="within one node"):
        multihost.check_tp_within_nodes(nodes, 3, local=4)
    # Nodes that interleave their ranks: tp=2 divides the local count but
    # each pair spans two nodes.
    with pytest.raises(ValueError, match="spans nodes"):
        multihost.check_tp_within_nodes([r % 2 for r in range(8)], 2, local=4)


def test_initialize_reads_env_and_arguments(monkeypatch):
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")

    # torchrun's environment: the group reads it (env://).
    for k, v in {"RANK": "2", "WORLD_SIZE": "3", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "h", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    multihost.initialize()
    assert calls.pop() == ("gloo", {})

    # Explicit arguments win.
    multihost.initialize(coordinator_address="h:1234", num_processes=3, process_id=2)
    assert calls.pop() == ("gloo", {"init_method": "tcp://h:1234", "world_size": 3,
                                    "rank": 2})

    # Neither: a message, no group.
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k)
    with pytest.raises(SystemExit, match="torchrun"):
        multihost.initialize()
    with pytest.raises(SystemExit, match="torchrun"):
        multihost.initialize(coordinator_address="h:1234")
    assert not calls


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


WORKER = r"""
import os, sys
import numpy as np
import torch
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
# torchrun's environment for 2 nodes x 2 processes.
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % 2),
                  LOCAL_WORLD_SIZE="2", GROUP_RANK=str(rank // 2),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
torch.set_num_threads(1)
import torch.distributed as dist
from fadtk_tpu_torch.metric.stats import (welford_finalize, welford_init,
                                          welford_merge_across, welford_update)
from fadtk_tpu_torch.parallel import multihost

multihost.initialize()
assert dist.get_world_size() == 4 and dist.get_rank() == rank
mesh = multihost.global_mesh(tp=2)
assert (mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank) == (2, 2, rank // 2, rank % 2), mesh

n, d = 64, 6
full = (np.arange(n * d, dtype=np.float32).reshape(n, d) % 17) * 0.25
rows = torch.from_numpy(full.reshape(2, n // 2, d)[mesh.dp_rank].copy())
st = welford_merge_across(welford_update(welford_init(d), rows), mesh.dp_group)
mu, cov = welford_finalize(st)
np.testing.assert_allclose(mu.numpy(), full.mean(0), rtol=1e-6, atol=1e-6)
np.testing.assert_allclose(cov.numpy(), np.cov(full, rowvar=False), rtol=1e-5, atol=1e-5)
try:
    multihost.global_mesh(tp=4)
except ValueError as e:
    assert "within one node" in str(e), e
else:
    raise AssertionError("tp=4 over 2 processes a node was accepted")
dist.destroy_process_group()
print(f"RANK{rank}_OK")
"""


def test_two_nodes_of_two_gloo_smoke():
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": str(REPO), "FADTK_TPU_TORCH_DEVICE": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "4", port], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert all(f"RANK{r}_OK" in out for r, out in enumerate(outs))


def _datasets(root: Path) -> None:
    from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16

    for name, seed in (("a", 5), ("b", 6)):
        d = root / name
        d.mkdir(parents=True)
        r = np.random.default_rng(seed)
        for i in range(2):
            t = np.arange(int(16000 * 1.1)) / 16000
            x = 0.3 * np.sin(2 * np.pi * r.uniform(200, 1500) * t)
            write_wav_int16(d / f"c{i}.wav", float_to_int16(x), 16000)


def _score(csv: Path) -> float:
    rows = csv.read_text().strip().split("\n")
    assert len(rows) == 2 and rows[1].startswith("vggish,")
    return float(rows[1].split(",")[3])


def test_cli_multihost_matches_one_process(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "FADTK_TPU_TORCH_DEVICE": "cpu",
           "FADTK_TPU_RANDOM_WEIGHTS": "1", "FADTK_TPU_CHECKPOINTS": str(tmp_path / "none")}
    env.pop("FADTK_TPU_BF16", None)
    scores = {}
    for name, launch in (
        ("plain", [sys.executable, "-m", "fadtk_tpu_torch"]),
        ("multihost1", [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                        "--nproc-per-node", "1", "--master-port", str(_free_port()),
                        "-m", "fadtk_tpu_torch"]),
        ("multihost2", [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                        "--nproc-per-node", "2", "--master-port", str(_free_port()),
                        "-m", "fadtk_tpu_torch"]),
    ):
        work = tmp_path / name
        _datasets(work)
        flags = ["--device-pipeline", "--batch", "2"]
        if name != "plain":
            flags.append("--multihost")
        p = subprocess.run([*launch, "vggish", str(work / "a"), str(work / "b"),
                            str(work / "out.csv"), *flags],
                           env=env, capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
        scores[name] = _score(work / "out.csv")
    for name in ("multihost1", "multihost2"):
        assert abs(scores[name] - scores["plain"]) <= SCORE_RTOL * abs(scores["plain"]), scores
