"""The readers of the program's own spans and counters, on a traced tiny run
on the CPU: ``loader_audio_s_per_s`` and ``step_host_share`` read a number,
``step_gap_share`` nothing (its CUDA events need a card). The program's
padding counters give exactly the ``pad_share`` of the harness's step
wrapper, and its span ``pipeline.wait_clips`` the wrapper's ``loader_wait``
to within 5% of the window."""

import pytest

from portbench import harness
from portbench.drivers import dataset_stats
from tiny import make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tracing"))


def test_the_program_sees_what_the_wrappers_see(tmp_path, root, monkeypatch):
    from fadtk_tpu_torch.runner import profiling

    seen = []
    window = dataset_stats.window
    monkeypatch.setattr(dataset_stats, "window", lambda ctx: (seen.append(ctx), window(ctx)))
    result = run_tiny(tmp_path, root, monkeypatch, trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert m["loader_audio_s_per_s"]["value"] > 0
    assert m["loader_audio_s_per_s"]["unit"] == "audio-s/s"
    assert 0 < m["step_host_share"]["value"] < 1
    assert "step_gap_share" not in m

    rec = seen[0].record
    s = profiling.snapshot()
    c = s["counters"]
    assert c["pipeline.steps"] == rec.counters["steps"]
    assert c["pipeline.rows"] == rec.counters["rows"]
    assert 1 - c["pipeline.valid_samples"] / c["pipeline.bucket_samples"] == m["pad_share"]["value"]
    wait = s["seconds"]["pipeline.wait_clips"]
    assert abs(wait - rec.span_total("loader_wait")) <= 0.05 * rec.window_s
    assert m["step_host_share"]["value"] == s["seconds"]["pipeline.step"] / rec.window_s
    assert m["loader_audio_s_per_s"]["value"] == c["loader.audio_s"] / s["seconds"]["loader.window"]
    # every window call's clips, at the tiny configuration's 1 s each
    assert c["loader.audio_s"] == pytest.approx(len(rec.calls) * 16 * 1.0, rel=1e-3)


def test_a_program_without_the_record_reads_nothing(monkeypatch):
    """The parent program's profiling module has no ``snapshot``."""
    from types import SimpleNamespace

    from fadtk_tpu_torch.runner import profiling

    monkeypatch.delattr(profiling, "snapshot")
    ctx = SimpleNamespace(record=SimpleNamespace(window_s=1.0))
    for name in ("loader_audio_s_per_s", "step_host_share", "step_gap_share"):
        assert harness.metric_reader(name).read(ctx) is None
