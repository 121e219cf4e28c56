"""Driver of the dataset-statistics cells: the window calls
``fadtk_tpu_torch.runner.device_pipeline.dataset_stats_device`` back to back,
one dataset (an explicit list of pool files in a seeded order) a call, until
``--seconds`` have passed; the call in flight is finished.

Set-up writes the pool, makes the weights on the device, loads them into the
program's model and warms up with one call that holds a batch of each padded
shape the window's calls use. Under ``--trace 1`` the
program is wrapped, from here, at run time: ``ClipLoader.iter_clips`` (the
host span ``loader_wait`` around each clip the loop waits for), the step of
``make_sharded_eval_step`` (the ``portbench.step`` range and the counters
``rows``, ``bucket_samples`` and ``valid_samples``), and the functions the
metric files name in their ``RANGES`` (``portbench.<range>``).
"""

from __future__ import annotations

import importlib
import os
import sys
import time
from collections import Counter

import numpy as np

from .. import compare, traffic
from ..trace import RANGE_PREFIX, timed_span


def family(ctx):
    return importlib.import_module(f"portbench.families.{ctx.config['family']}")


def setup(ctx) -> None:
    import torch

    fam = family(ctx)
    t = ctx.traffic
    marks = [("start", time.time())]
    if ctx.rank == 0:
        ctx.files, ctx.lengths = traffic.write_pool(t, ctx.seed, ctx.pool_dir, ctx.device)
        os.sync()  # the pool's writeback happens here, not in the window
    else:
        ctx.lengths = traffic.pool_lengths(t, ctx.seed)
        ctx.files = [ctx.pool_dir / f"clip{i:04d}.wav" for i in range(t.pool_files)]
    ctx.barrier()  # the pool is written before any rank reads it
    marks.append(("pool", time.time()))
    ctx.weights = fam.make_weights(ctx.config, ctx.seed, ctx.device)
    ctx.model = fam.program_model(ctx.config, ctx.weights)
    marks.append(("weights and model", time.time()))

    from fadtk_tpu_torch.parallel.mesh import make_mesh

    ctx.mesh = make_mesh()
    if ctx.mesh.dp != ctx.config["dp"] or ctx.mesh.tp != ctx.config["tp"]:
        raise RuntimeError(f"mesh dp={ctx.mesh.dp} tp={ctx.mesh.tp} is not the configuration's")
    ctx.batch = ctx.config["batch_per_card"] * ctx.mesh.dp
    samples = fam.model_samples(ctx.config, ctx.lengths, t.source_rate)
    ctx.clip_flops = np.array([fam.clip_flops(ctx.config, s) for s in samples], np.float64)
    ctx.clip_seconds = ctx.lengths / t.source_rate
    _call(ctx, warm_up_files(ctx, fam, samples))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm-up call", time.time()))
    if ctx.rank == 0:
        print("portbench: set-up " + ", ".join(
            f"{name} {t1 - t0:.2f} s" for (_, t0), (name, t1) in zip(marks, marks[1:])),
            file=sys.stderr)


def warm_up_files(ctx, fam, samples, calls: int = 64) -> list:
    """The first batch of each padded shape in the first ``calls`` dataset
    calls, more than any window holds, one after another."""
    first = {}
    for k in range(calls):
        order = traffic.call_order(ctx.traffic, ctx.seed, k)
        for b in range(0, len(order), ctx.batch):
            batch = order[b:b + ctx.batch]
            first.setdefault(fam.batch_shape(ctx.config, samples[batch]), batch)
    return [ctx.files[i] for batch in first.values() for i in batch]


def _call(ctx, files):
    from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device

    return dataset_stats_device(ctx.model, files, mesh=ctx.mesh, batch=ctx.batch)


def instrument(ctx, monkeypatch) -> None:
    """Wrap the program's loader and step, and the metric files' ranges."""
    from torch.profiler import record_function

    from fadtk_tpu_torch.runner import device_pipeline as dp

    rec = ctx.record

    class TimedLoader(dp.ClipLoader):
        def iter_clips(self, files):
            it = super().iter_clips(files)
            while True:
                with timed_span(rec, "loader_wait"), record_function(RANGE_PREFIX + "loader_wait"):
                    try:
                        clip = next(it)
                    except StopIteration:
                        return
                yield clip

    make_step = dp.make_sharded_eval_step

    def counted_make_step(*a, **k):
        step = make_step(*a, **k)

        def counted(shard, audio, num_valid):
            rec.counters["steps"] += 1
            rec.counters["rows"] += audio.shape[0]
            rec.counters["bucket_samples"] += audio.shape[0] * audio.shape[1]
            rec.counters["valid_samples"] += float(np.asarray(num_valid, np.int64).sum())
            with record_function(RANGE_PREFIX + "step"):
                return step(shard, audio, num_valid)

        return counted

    monkeypatch(dp, "ClipLoader", TimedLoader)
    monkeypatch(dp, "make_sharded_eval_step", counted_make_step)
    for name, targets in ctx.ranges.items():
        for target in targets:
            module, attr = target.split(":")
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            monkeypatch(mod, attr, _ranged(fn, RANGE_PREFIX + name))


def _ranged(fn, label):
    from torch.profiler import record_function

    def wrapped(*a, **k):
        with record_function(label):
            return fn(*a, **k)

    for attr, value in vars(fn).items():  # keep the program's launch counters readable
        setattr(wrapped, attr, value)
    return wrapped


def window(ctx) -> None:
    """Dataset calls until ``ctx.seconds`` have passed (rank 0 decides, every
    rank follows), then the call in flight finishes."""
    from torch.profiler import record_function

    rec = ctx.record
    t = ctx.traffic
    k = 0
    with record_function(RANGE_PREFIX + "window"):
        t0 = time.perf_counter()
        while True:
            order = traffic.call_order(t, ctx.seed, k)
            t_call = time.perf_counter()
            with record_function(RANGE_PREFIX + "call"):
                mu, cov, n = _call(ctx, [ctx.files[i] for i in order])
            rec.calls.append({"order": order, "mu": mu, "cov": cov, "n": n,
                              "seconds": time.perf_counter() - t_call,
                              "audio_s": float(ctx.clip_seconds[order].sum()),
                              "flops": float(ctx.clip_flops[order].sum())})
            k += 1
            if not ctx.agree(time.perf_counter() - t0 < ctx.seconds):
                break
        rec.window_s = time.perf_counter() - t0


def check(ctx, control: bool = False):
    """Per-call readings of the program against the reference, and with
    ``control`` those of the control (the reference in TF32, in the
    program's place) on the same calls, else None."""
    from ..reference.gaussian import dataset_gaussian

    fam = family(ctx)
    ref = fam.reference_moments(ctx.config, ctx.weights, ctx.files, ctx.device)
    low = (fam.reference_moments(ctx.config, ctx.weights, ctx.files, ctx.device, tf32=True)
           if control else None)
    program, lower = [], []
    for call in ctx.record.calls:
        counts = np.zeros(ctx.traffic.pool_files, np.int64)
        for i, c in Counter(call["order"]).items():
            counts[i] = c
        mu_r, cov_r, n_r = dataset_gaussian(ref, counts)
        program.append(compare.compare_call(call["mu"], call["cov"], call["n"], mu_r, cov_r, n_r))
        if low is not None:
            lower.append(compare.compare_call(*dataset_gaussian(low, counts), mu_r, cov_r, n_r))
    return program, (lower if control else None)
