"""A tiny tree for running the harness on the CPU: one cell of a narrow
speech encoder (seven convs of width 16 with the published kernels and
strides, hidden 64, 4 heads, 2 layers, 8 kHz) on a small pool, with the
benchmark's own metric readers. ``run_tiny`` runs it in this process with
the tiny model in the registry's place."""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
RUN = REPO / "portbench" / "run.py"

TINY_FIELDS = dict(model="tiny-speech", sampling_rate=8000, layer=2, batch_per_card=4,
                   conv_dim=[16] * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, do_normalize=True)


def tiny_model(name):
    """The registry's model, narrowed to ``TINY_FIELDS``."""
    from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
    from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel

    cfg = SpeechEncoderConfig(conv_dim=(16,) * 7, hidden_size=64, num_layers=2, num_heads=4,
                              intermediate_size=128, num_conv_pos_embeddings=16,
                              num_conv_pos_embedding_groups=4, do_normalize=True)
    return SpeechEmbeddingModel("tiny-speech", 64, 8000, cfg, 2, "test/tiny-speech")


def make_root(tmp: Path, chips: int = 1) -> Path:
    """A tree with BENCHMARK.json's one cell ``tiny.cell`` and its files."""
    root = tmp / "root"
    pb = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pb / d).mkdir(parents=True)
    os.symlink(REPO / "portbench" / "metrics", pb / "metrics")
    cfg = json.loads((REPO / "portbench/configs/w2v2-base.json").read_text())
    cfg.update(TINY_FIELDS, chips=chips, dp=chips)
    (pb / "configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / "portbench/traffic/songs.json").read_text())
    tr.update(pool_files=8, clips_per_call=16)
    tr.update(lengths={"kind": "fixed", "seconds": 1.0})
    (pb / "traffic/tiny.json").write_text(json.dumps(tr))
    limits = json.loads((REPO / "portbench/limits/w2v2-base.songs.json").read_text())
    (pb / "limits/tiny.cell.json").write_text(json.dumps(limits))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    m["configs"] = [dict(m["configs"][0], name="tiny", file="portbench/configs/tiny.json")]
    m["workloads"] = [dict(m["workloads"][0], name="tiny.cell", config="tiny", traffic="tiny",
                           chips=chips)]
    for x in m["per_layer"]:
        x["workloads"] = ["tiny.cell"]
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def run_tiny(tmp: Path, root: Path, monkeypatch, seed: int = 2**31 + 7,
             trace: bool = False) -> dict:
    """One run of ``tiny.cell`` on the CPU, here, with whatever the caller
    has patched into the program; the result line's dict. The environment
    the harness sets is put back afterwards."""
    from portbench import harness
    from portbench.families import speech

    monkeypatch.setattr(speech, "registry_model", tiny_model)
    saved = dict(os.environ)
    try:
        return harness.run_cell("tiny.cell", seed, 1.0, trace, pool_dir=tmp / f"pool{seed}",
                                t_start=time.time(), cpu=True, root=root)
    finally:
        os.environ.clear()
        os.environ.update(saved)


RANK = """
import json, sys, time
from pathlib import Path
sys.path[:0] = [{repo!r}, {tests!r}]
from portbench import harness
from portbench.families import speech
import tiny, test_portbench_faults as faults
speech.registry_model = tiny.tiny_model
for name in {faults!r}:
    faults.FAULTS[name](setattr)
r = harness.run_cell("tiny.cell", {seed}, 1.0, False, rank={rank}, world={world}, port={port},
                     pool_dir=Path({pool!r}), t_start=time.time(), cpu=True, root=Path({root!r}))
if r is not None:
    print(json.dumps(r))
"""


def run_ranks(tmp: Path, root: Path, world: int, faults: tuple = (),
              seed: int = 2**31 + 7, timeout: float = 300) -> tuple[dict | None, str]:
    """``tiny.cell`` on ``world`` CPU processes joined over gloo, each with
    ``faults`` (names in ``test_portbench_faults.FAULTS``) planted; (rank
    0's result or None, the ranks' standard error)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "TMPDIR": str(tmp)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK.format(repo=str(REPO), tests=str(Path(__file__).parent),
                                           faults=tuple(faults), seed=seed, rank=r, world=world,
                                           port=port, pool=str(tmp / f"pool{seed}"),
                                           root=str(root))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    err = "".join(e for _, e in outs)
    if any(p.returncode for p in procs):
        return None, err
    lines = outs[0][0].strip().splitlines()
    return (json.loads(lines[-1]) if lines else None), err
