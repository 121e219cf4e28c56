"""The port's tracing (``fadtk_tpu_torch/runner/profiling.py``) on the CPU.

A narrow speech encoder (seven convs of width 16 with the published kernels
and strides, hidden 64, 4 heads, 2 layers) at 8 kHz, random weights, scores
five clips of 0.3-1.2 s in batches of 2 through ``dataset_stats_device``:
one clip is a convert-cache hit, the rest are misses at the model's rate (so
the resample span times the resampler's identity). Off, a pass records
nothing and opens no profiler range; under ``torch.profiler`` it records
every span and counter, its counters add up by hand, its main-thread ranges
reach the profiler's events, and its statistics are bit-identical to an
untraced pass. ``FADTK_TPU_TRACE`` writes one chrome trace a pass. The
loader counts its windows and the BLAS width each was decoded at. The
device events (``pipeline.step_device_s`` / ``device_gap_s``) need a card.
"""

import json
import logging
import os
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fadtk_tpu_torch.audio.wavio import float_to_int16, write_wav_int16
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.family import SpeechEmbeddingModel
from fadtk_tpu_torch.parallel import dp as dp_mod
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.runner import convert, profiling
from fadtk_tpu_torch.runner.convert import ClipLoader
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device
from fadtk_tpu_torch.runner.fad import FrechetAudioDistance

SR = 8000
CFG = SpeechEncoderConfig(
    conv_dim=(16,) * 7, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, do_normalize=True,
)
BATCH = 2

PIPELINE_SPANS = {"pipeline.wait_clips", "pipeline.pad", "pipeline.step", "pipeline.merge",
                  "pipeline.checkpoint", "pipeline.fetch"}
LOADER_SPANS = {"loader.window", "loader.decode", "loader.resample", "loader.quantise"}
MODEL_SPANS = {"model.extractor", "model.attention", "model.ffn", "step.stats"}
COUNTERS = {"pipeline.steps", "pipeline.rows", "pipeline.pad_rows", "pipeline.valid_samples",
            "pipeline.bucket_samples", "loader.audio_s", "loader.files", "loader.hits",
            "loader.misses", "loader.windows", "loader.blas_threads"}
# Opened on the thread that drives the pass, so in the profiler's events.
MAIN_THREAD = (PIPELINE_SPANS | MODEL_SPANS | {"loader.window"})


ENV = {"FADTK_TPU_TORCH_DEVICE": "cpu", "FADTK_TPU_RANDOM_WEIGHTS": "1",
       "FADTK_TPU_CKPT_FILES": "2"}
UNSET = ("FADTK_TPU_CKPT", profiling.ENV, "FADTK_TPU_CONVERT_TRANSPORT")


@contextmanager
def environment(checkpoints: Path):
    with mock.patch.dict(os.environ, {**ENV, "FADTK_TPU_CHECKPOINTS": str(checkpoints)}):
        for k in UNSET:
            os.environ.pop(k, None)
        yield


@pytest.fixture(autouse=True)
def _env(tmp_path):
    with environment(tmp_path / "no-checkpoints"):
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset (file 0 with a convert-cache entry), the loaded model,
    the clips the loader yields and an untraced pass's statistics."""
    d = tmp_path_factory.mktemp("tracing")
    rng = np.random.default_rng(3)
    files = []
    for i in range(5):
        t = np.arange(int(SR * rng.uniform(0.3, 1.2))) / SR
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 1500) * t)
        write_wav_int16(d / f"c{i}.wav", float_to_int16(x), SR)
        files.append(d / f"c{i}.wav")
    with environment(d / "no-checkpoints"):
        model = SpeechEmbeddingModel("tiny-speech", 64, SR, CFG, 2, "test/tiny-speech")
        model.ensure_loaded()
        FrechetAudioDistance(model, load_model=False).load_audio(files[0])
        clips = list(ClipLoader(model, workers=2).iter_clips(files))
        plain = run(model, files, d)
    return {"dir": d, "files": files, "model": model, "clips": clips, "plain": plain}


def blas_width(workers: int) -> int:
    """The numpy BLAS width a decode pool of ``workers`` runs its windows at."""
    blas = convert.numpy_openblas()
    if blas is None:
        return convert.usable_cores()
    return min(blas.get(), max(1, convert.usable_cores() // workers))


def run(model, files, d: Path):
    return dataset_stats_device(model, files, batch=BATCH, workers=2,
                                checkpoint=d / "ckpt.npz")


def profiled(model, files, d: Path):
    """A pass under a CPU profiler: (statistics, record, profiler event names).
    The refresh outside the profiler turns tracing off first, so the pass
    starts a record of its own."""
    assert not profiling.refresh()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(model, files, d)
    return out, profiling.snapshot(), {e.name for e in prof.events()}


@pytest.fixture(scope="module")
def traced(data):
    """One pass under a CPU profiler: (statistics, record, event names)."""
    with environment(data["dir"] / "no-checkpoints"):
        return profiled(data["model"], data["files"], data["dir"])


def test_off_records_nothing_and_opens_no_range(data, monkeypatch):
    ranges, spans = [], []
    real_range, real_span = profiling.record_function, profiling._Span
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: ranges.append(name) or real_range(name))
    monkeypatch.setattr(profiling, "_Span", lambda name: spans.append(name) or real_span(name))
    monkeypatch.setattr(profiling, "_rec", profiling._Record())
    monkeypatch.setattr(profiling, "_timing_event", lambda device: pytest.fail("an event"))
    run(data["model"], data["files"], data["dir"])
    assert not profiling.refresh()
    assert ranges == [] and spans == []
    assert profiling.snapshot() == {"seconds": {}, "calls": {}, "counters": {}}


def test_on_records_every_span_and_counter(traced):
    _, snap, _ = traced
    assert PIPELINE_SPANS | LOADER_SPANS | MODEL_SPANS <= set(snap["seconds"])
    assert COUNTERS <= set(snap["counters"])
    c = snap["counters"]
    assert (c["loader.files"], c["loader.hits"], c["loader.misses"]) == (5, 1, 4)
    assert (c["loader.windows"], c["loader.blas_threads"]) == (1, blas_width(2))  # window of 8
    calls = snap["calls"]
    assert calls["pipeline.step"] == calls["pipeline.merge"] == 3  # 5 clips, batches of 2
    assert calls["pipeline.checkpoint"] == 2  # at 2 and 4 files
    assert calls["model.attention"] == calls["model.ffn"] == 3 * CFG.num_layers
    # the CUDA events of the step clock need a card
    assert "pipeline.step_device_s" not in c and "pipeline.device_gap_s" not in c


def test_loader_audio_s_is_the_clips_samples_over_sr(data, traced):
    _, snap, _ = traced
    want = 0.0
    for clip in data["clips"]:
        want += clip.shape[0] / SR
    assert snap["counters"]["loader.audio_s"] == want


def test_pad_counters_give_the_pad_share_by_hand(data, traced):
    _, snap, _ = traced
    lengths = [c.shape[0] for c in data["clips"]]
    assert max(lengths) < 10 * SR  # every batch pads to the one 10 s bucket
    rows, pad_rows, bucket = 6, 1, 10 * SR  # 3 steps of 2, the last with one pad row
    valid = sum(lengths) + pad_rows  # num_valid marks one sample of a pad row
    c = snap["counters"]
    assert (c["pipeline.steps"], c["pipeline.rows"], c["pipeline.pad_rows"]) == (3, rows, pad_rows)
    assert (c["pipeline.bucket_samples"], c["pipeline.valid_samples"]) == (rows * bucket, valid)
    share = 1 - c["pipeline.valid_samples"] / c["pipeline.bucket_samples"]
    assert share == pytest.approx(1 - valid / (rows * bucket), abs=0)


def test_main_thread_ranges_reach_the_profiler_and_worker_spans_do_not(traced):
    _, _, names = traced
    assert {profiling.PREFIX + n for n in MAIN_THREAD} <= names
    # the decode threads' spans reach the totals only
    assert not {profiling.PREFIX + n for n in LOADER_SPANS - {"loader.window"}} & names


@pytest.mark.parametrize("workers", [1, 8])
def test_loader_counts_windows_and_the_blas_width_of_each(data, workers):
    files = data["files"] * 4  # 20 files: windows of 8 (one worker) or 32
    assert not profiling.refresh()  # off, so the loader starts a record of its own
    with profile(activities=[ProfilerActivity.CPU]):
        clips = list(ClipLoader(data["model"], workers=workers).iter_clips(files))
    c = profiling.snapshot()["counters"]
    windows = 3 if workers == 1 else 1
    assert len(clips) == 20 and c["loader.windows"] == windows
    assert c["loader.blas_threads"] / c["loader.windows"] == blas_width(workers)


def test_second_profiled_pass_starts_a_fresh_record(data, traced):
    _, first, _ = traced
    run(data["model"], data["files"][:3], data["dir"])  # untraced: tracing turns off
    with profile(activities=[ProfilerActivity.CPU]):
        run(data["model"], data["files"][:3], data["dir"])
    second = profiling.snapshot()
    assert first["counters"]["loader.files"] == 5
    assert second["counters"]["loader.files"] == 3
    assert second["calls"]["pipeline.step"] == 2
    assert second["counters"]["pipeline.rows"] == 4


def test_stats_are_bit_identical_with_tracing_on_and_off(data, traced):
    (mu, cov, n), _, _ = traced
    mu0, cov0, n0 = data["plain"]
    assert n == n0
    assert np.array_equal(mu, mu0) and np.array_equal(cov, cov0)


def test_env_trace_writes_a_chrome_trace_a_pass(data, tmp_path, monkeypatch, caplog):
    out = tmp_path / "traces"
    monkeypatch.setenv(profiling.ENV, str(out))
    with caplog.at_level(logging.INFO, logger="fadtk_tpu_torch"):
        stats = run(data["model"], data["files"], data["dir"])
        run(data["model"], data["files"][:2], data["dir"])
    assert sorted(p.name for p in out.iterdir()) == ["trace-rank0-0.json", "trace-rank0-1.json"]
    names = {e.get("name") for e in json.loads((out / "trace-rank0-0.json").read_text())
             ["traceEvents"]}
    assert "fadtk.pipeline.step" in names and "fadtk.model.attention" in names
    c = profiling.snapshot()["counters"]
    assert c["loader.files"] == 2  # the second pass's own
    assert (c["loader.windows"], c["loader.blas_threads"]) == (1, blas_width(2))
    assert not profiling.refresh()  # off once the pass's session ends
    lines = [r.message for r in caplog.records if r.message.startswith("[profile]")]
    assert len(lines) == 4 and "pipeline.step=" in lines[0]  # totals and path, a pass each
    assert all(np.array_equal(a, b) for a, b in zip(stats, data["plain"]))


def test_cached_path_logs_profile_only_under_tracing(data, tmp_path, monkeypatch, caplog):
    import shutil

    from fadtk_tpu_torch.runner.batch import cache_embedding_files

    for k, sub in enumerate(("off", "on")):
        d = tmp_path / sub
        d.mkdir()
        for f in data["files"][1:3]:
            shutil.copy(f, d / f.name)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="fadtk_tpu_torch"):
            if k:
                forwards = []
                real = data["model"]._forward
                monkeypatch.setattr(data["model"], "_forward",
                                    lambda *a: forwards.append(a) or real(*a))
                with profile(activities=[ProfilerActivity.CPU]):
                    cache_embedding_files(d, data["model"], workers=2)
                calls = profiling.snapshot()["calls"]
            else:
                cache_embedding_files(d, data["model"], workers=2)
        lines = [r.message for r in caplog.records if r.message.startswith("[profile]")]
        if k:
            assert len(lines) == 1 and "embed=" in lines[0] and "loader.resample=" in lines[0]
            # the cached forward is the step's: one span of each per layer run
            layers = data["model"].layer
            assert forwards and calls["model.extractor"] == len(forwards)
            assert calls["model.attention"] == calls["model.ffn"] == layers * len(forwards)
        else:
            assert lines == []


def test_dp_loops_record_the_pipeline_spans_and_pad_counters():
    """The chunked and whole-clip loops of parallel/dp.py, with a forward
    that averages each row, over clips of 5, 3 and 4 samples."""
    mesh = make_mesh()
    clips = [np.arange(n, dtype=np.float32) for n in (5, 3, 4)]
    chunk = dp_mod.DpChunkSpec(forward=lambda x: x.mean(-1, keepdim=True).expand(-1, 2),
                               make_chunks=lambda c: (c[: len(c) // 2 * 2].reshape(-1, 2),),
                               num_features=2, preferred_batch=4)
    whole = dp_mod.DpWholeClipSpec(forward=lambda x: x.mean(-1, keepdim=True).expand(-1, 2),
                                   prepare=lambda c: c, num_features=2, preferred_batch=4)
    for spec, run_dp, want in (
            # 2 + 1 + 2 chunks of 2 samples: one batch of 4 rows, one of 1
            (chunk, dp_mod.dp_chunk_dataset_stats, (2, 5, 0, 10, 10)),
            # three shapes, each its own batch of one row
            (whole, dp_mod.dp_whole_clip_dataset_stats, (3, 3, 0, 12, 12))):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert profiling.refresh()  # as dataset_stats_device does at a pass's start
            run_dp(spec, iter(clips), mesh)
        snap = profiling.snapshot()
        assert {"pipeline.wait_clips", "pipeline.step", "pipeline.fetch"} <= set(snap["seconds"])
        assert snap["calls"]["pipeline.wait_clips"] == 4  # three clips and the end
        c = snap["counters"]
        assert tuple(c[k] for k in ("pipeline.steps", "pipeline.rows", "pipeline.pad_rows",
                                    "pipeline.bucket_samples", "pipeline.valid_samples")) == want
        assert "fadtk.pipeline.step" in {e.name for e in prof.events()}
        assert not profiling.refresh()  # off, so the next loop starts afresh
