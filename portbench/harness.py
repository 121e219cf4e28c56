"""One run of one cell: set-up, the measured window, the trace, the check and
the result line. Everything that belongs to one configuration, traffic mix
or metric is found by its name in ``BENCHMARK.json``:

- the configuration: ``portbench/configs/<name>.json`` (its family's code in
  ``portbench/families/<family>.py``, its reference in
  ``portbench/reference``);
- the traffic mix: ``portbench/traffic/<name>.json``, whose ``driver`` names
  the window's code in ``portbench/drivers``;
- each metric: a reader ``portbench/metrics/<name>.py`` with
  ``read(ctx) -> float | None``, and optionally ``RANGES``: profiler ranges
  to wrap around functions of the program under ``--trace 1``;
- the limits of the comparison: ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import compare, manifest, traffic
from .trace import Record, summarize, top

ROOT = manifest.ROOT
METRICS_DIR = Path(__file__).resolve().parent / "metrics"


def metric_reader(name: str, directory: Path = METRICS_DIR):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Context:
    """What the driver and the readers see of a run."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: traffic.Traffic
    rank: int
    world: int
    device: object
    pool_dir: Path
    record: Record = field(default_factory=Record)
    ranges: dict = field(default_factory=dict)
    setup_s: float = 0.0
    busy_s_ranks: list = field(default_factory=list)

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()

    def agree(self, go: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.world == 1:
            return go
        import torch
        import torch.distributed as dist

        flag = torch.tensor([1 if go else 0], device=self.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())


class Patches:
    """Attribute replacements undone in reverse order."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, attr, value):
        self.saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def undo(self):
        while self.saved:
            obj, attr, value = self.saved.pop()
            setattr(obj, attr, value)


def prepare_environment(config: dict, root: Path = ROOT) -> None:
    """The precision the configuration states, no JAX for libraries that
    would load it, and build caches at fixed paths inside the checkout."""
    os.environ["FADTK_TPU_BF16"] = "1" if config["precision"] == "bfloat16" else ""
    os.environ["USE_FLAX"] = "0"
    cache = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, rank: int = 0,
             world: int | None = None, port: int | None = None, pool_dir: Path,
             t_start: float, cpu: bool = False, control: bool = False,
             root: Path = ROOT) -> dict | None:
    """Run one cell on this rank; the result line's dict on rank 0."""
    m = manifest.load(root)
    cell = manifest.cell(m, workload)
    config = manifest.config(m, cell["config"], root)
    world = world if world is not None else cell["chips"]
    prepare_environment(config, root)
    if cpu:
        os.environ["FADTK_TPU_TORCH_DEVICE"] = "cpu"

    import torch

    if cpu:
        device = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    if world > 1:
        import datetime

        import torch.distributed as dist

        dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))

    t = traffic.load_traffic(cell["traffic"], root / "portbench" / "traffic")
    ctx = Context(workload, seed, seconds, trace, cell, config, t, rank, world, device,
                  Path(pool_dir))
    ctx.record.chips = world
    ctx.record.precision = config["precision"]
    e2e, layer = manifest.cell_metrics(m, workload)
    readers = {x["name"]: metric_reader(x["name"], root / "portbench" / "metrics")
               for x in (layer if trace else e2e)}
    for r in readers.values():
        for name, targets in getattr(r, "RANGES", {}).items():
            ctx.ranges.setdefault(name, []).extend(targets)

    driver = importlib.import_module(f"portbench.drivers.{t.spec['driver']}")
    t_driver = time.time()
    driver.setup(ctx)
    ctx.barrier()
    ctx.setup_s = time.time() - t_start
    if rank == 0:
        print(f"portbench: set-up {ctx.setup_s:.2f} s, of which process start, imports and "
              f"the card {t_driver - t_start:.2f} s", file=sys.stderr)

    patches = Patches()
    prof = None
    if trace:
        driver.instrument(ctx, patches)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_peak = torch.cuda.max_memory_allocated(device) if not cpu else 0
    if not cpu:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        driver.window(ctx)
        if not cpu:
            torch.cuda.synchronize(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        patches.undo()
    window_peak = torch.cuda.max_memory_allocated(device) if not cpu else 0
    ctx.record.peak_window_bytes = window_peak
    if prof is not None:
        ctx.record.trace = summarize(prof)
        del prof
    mine = {"busy_s": (ctx.record.trace or {}).get("busy_s"),
            "peak": max(setup_peak, window_peak)}
    if world > 1:
        import torch.distributed as dist

        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        dist.barrier()
        dist.destroy_process_group()
    else:
        gathered = [mine]
    if rank != 0:
        return None
    ctx.busy_s_ranks = [g["busy_s"] for g in gathered]

    # The program's state goes before the reference runs; the weights stay,
    # the reference reads the same tensors.
    ctx.model = ctx.mesh = None
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    print("portbench: call seconds " + " ".join(f"{c['seconds']:.3f}" for c in ctx.record.calls),
          file=sys.stderr)
    t_check = time.time()
    program, lower = driver.check(ctx, control=control)
    print(f"portbench: the check took {time.time() - t_check:.1f} s", file=sys.stderr)
    if trace and ctx.record.trace:
        for name, ops in ctx.record.trace["range_ops"].items():
            print(f"portbench: device s under portbench.{name} by kernel: {top(ops, 6, 80)}",
                  file=sys.stderr)
    limits = compare.load_limits(workload, root / "portbench" / "limits")
    failed = sum(not compare.within(r, limits) for r in program)
    numbers = compare.worst(program)

    metrics = {}
    for x in (layer if trace else e2e):
        value = readers[x["name"]].read(ctx)
        if value is not None:
            metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    dev = {"platform": "cpu" if cpu else "gpu",
           "kind": "cpu" if cpu else torch.cuda.get_device_name(device),
           "count": world, "memory_peak_bytes": max(g["peak"] for g in gathered)}
    result = {"correct": failed == 0 and len(program) > 0, "attempted": len(program),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and ctx.record.trace:
        busy = [b for b in ctx.busy_s_ranks if b is not None]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = ctx.record.trace["window_s"]
        result["breakdown"] = {"device_ops": top(ctx.record.trace["kernels"]),
                               "idle_gaps": top(ctx.record.trace["idle"])}
    result["card"] = "cpu" if cpu else power_limit()
    if lower is not None:
        result["control"] = compare.worst(lower)
    result["calls_compared"] = program
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in compare.NUMBERS}
    return result
