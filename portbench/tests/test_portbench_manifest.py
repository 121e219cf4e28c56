"""BENCHMARK.json's form: names, units, keys, one line for each why, every
metric's ``moves`` reported by each cell that lists the metric, and the
configuration files it names."""

import copy
import json

import pytest

from portbench import manifest

M = manifest.load()


def test_the_manifest_is_sound():
    assert manifest.problems(M) == []


def test_command_and_paths():
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"] and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_configuration_files(name):
    entry = next(c for c in M["configs"] if c["name"] == name)
    cfg = manifest.config(M, name)
    assert entry["file"].startswith("portbench/configs/") and cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
    for k in ("model", "precision", "chips", "dp", "tp", "assumed", "hidden_size",
              "num_hidden_layers", "num_attention_heads", "intermediate_size"):
        assert k in cfg
    cells = [w for w in M["workloads"] if w["config"] == name]
    assert all(w["chips"] == cfg["chips"] == cfg["dp"] * cfg["tp"] for w in cells)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_has_its_traffic_limits_and_readers(cell):
    from pathlib import Path

    pb = Path(manifest.ROOT) / "portbench"
    w = manifest.cell(M, cell)
    assert (pb / "traffic" / f"{w['traffic']}.json").exists()
    limits = json.loads((pb / "limits" / f"{cell}.json").read_text())
    assert limits["n_mismatch"]["limit"] == 0
    e2e, layer = manifest.cell_metrics(M, cell)
    for x in e2e + layer:
        assert (pb / "metrics" / f"{x['name']}.py").exists()


BREAKS = [
    ("a name with a space", lambda m: m["workloads"][0].update(name="w2v2 base")),
    ("a unit with a space", lambda m: m["per_layer"][0].update(unit="audio s")),
    ("a Greek letter", lambda m: m["per_layer"][0].update(unit="µs")),
    ("a metric moving what its cell does not report",
     lambda m: m["per_layer"][0].update(moves="train_tokens_per_s")),
    ("a key of its own on a metric", lambda m: m["per_layer"][0].update(why="x")),
    ("a why on two lines", lambda m: m["workloads"][0].update(why="a\nb")),
    ("a bound over 0.25", lambda m: m["end_to_end"][0].update(bound=0.3)),
    ("a cell without setup_s", lambda m: m["end_to_end"].pop(1)),
    ("a repeated pair", lambda m: m["workloads"].append(dict(m["workloads"][0], name="x"))),
    ("a configuration without a cell", lambda m: m["configs"].append(
        dict(m["configs"][0], name="unused"))),
]


@pytest.mark.parametrize("what,breaks", BREAKS, ids=[b[0] for b in BREAKS])
def test_breaches_are_found(what, breaks):
    m = copy.deepcopy(M)
    breaks(m)
    assert manifest.problems(m)
