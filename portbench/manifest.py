"""``BENCHMARK.json``: loading, the look-ups by name, and the checks of its
form (names, units, keys, and that every cell reports what its metrics
move)."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(m: dict, workload: str) -> dict:
    for c in m["workloads"]:
        if c["name"] == workload:
            return c
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(m: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in m["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(m: dict, workload: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics the cell reports."""
    return ([x for x in m["end_to_end"] if applies(x, workload)],
            [x for x in m["per_layer"] if applies(x, workload)])


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def problems(m: dict) -> list[str]:
    """Every breach of the manifest's form found; empty when sound."""
    out = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
    for group, keys, extra in (("configs", CONFIG_KEYS, set()), ("workloads", CELL_KEYS, set()),
                               ("end_to_end", E2E_KEYS, {"workloads"}),
                               ("per_layer", LAYER_KEYS, {"workloads"})):
        names = [x.get("name") for x in m.get(group, [])]
        if len(set(names)) != len(names):
            out.append(f"{group}: repeated names")
        for x in m.get(group, []):
            if not (keys <= set(x) <= keys | extra):
                out.append(f"{group} {x.get('name')}: keys {sorted(x)}")
            if not NAME.match(str(x.get("name", ""))):
                out.append(f"{group}: bad name {x.get('name')!r}")
            if "unit" in x and not UNIT.match(x["unit"]):
                out.append(f"{x['name']}: bad unit {x['unit']!r}")
            if "better" in x and x["better"] not in ("lower", "higher"):
                out.append(f"{x['name']}: better {x['better']!r}")
            for k in ("why", "layer", "source"):
                if k in x and not _line(x[k]):
                    out.append(f"{x['name']}: {k} not one line of 1-200 characters")
    metric_names = [x["name"] for x in m.get("end_to_end", []) + m.get("per_layer", [])]
    if len(set(metric_names)) != len(metric_names):
        out.append("two metrics share a name")
    cells = {c["name"]: c for c in m.get("workloads", [])}
    configs = {c["name"] for c in m.get("configs", [])}
    pairs = [(c["config"], c["traffic"]) for c in cells.values()]
    if len(set(pairs)) != len(pairs):
        out.append("a pair of configuration and traffic appears twice")
    for c in cells.values():
        if c["config"] not in configs or not NAME.match(c["traffic"]) or c["chips"] not in (1, 4):
            out.append(f"cell {c['name']}: config, traffic or chips")
        e2e, layer = cell_metrics(m, c["name"])
        names = {x["name"] for x in e2e}
        if "setup_s" not in names or len(names) < 2 or not layer:
            out.append(f"cell {c['name']}: needs setup_s, another end-to-end metric and a per-layer one")
        for x in layer:
            if x["moves"] not in names:
                out.append(f"cell {c['name']}: {x['name']} moves {x['moves']}, which it does not report")
    for c in m.get("configs", []):
        if not any(w["config"] == c["name"] for w in cells.values()):
            out.append(f"config {c['name']} has no cell")
        for k in c.get("reduced", []):
            if not NAME.match(k):
                out.append(f"config {c['name']}: bad reduced key {k!r}")
    for x in m.get("end_to_end", []):
        if x.get("source") not in ("host_clock", "device_trace"):
            out.append(f"{x['name']}: end-to-end source {x.get('source')}")
        if not (0 < x.get("bound", 0) <= 0.25):
            out.append(f"{x['name']}: bound {x.get('bound')}")
    for x in m.get("per_layer", []):
        if x.get("source") not in ("host_clock", "device_trace", "program_span", "program_counter"):
            out.append(f"{x['name']}: source {x.get('source')}")
        for w in x.get("workloads", []):
            if w not in cells:
                out.append(f"{x['name']}: unknown workload {w}")
    return out
