"""pad_share's arithmetic, and the counts the harness's step wrapper takes."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.drivers import dataset_stats
from portbench.trace import Record

pad_share = harness.metric_reader("pad_share")


def ctx_with(counters):
    rec = Record()
    rec.counters.update(counters)
    return SimpleNamespace(record=rec)


def test_pad_share_by_hand():
    # Two steps of 4 rows in a 100-sample bucket: 4 x 100 + 4 x 100 handed,
    # valid 100 + 60 + 30 + 10 and 4 x 100.
    c = {"bucket_samples": 800.0, "valid_samples": 200.0 + 400.0}
    assert pad_share.read(ctx_with(c)) == pytest.approx(0.25)


def test_no_step_reads_nothing():
    assert pad_share.read(ctx_with({})) is None


def test_step_wrapper_counts_rows_bucket_and_valid_samples(monkeypatch):
    from fadtk_tpu_torch.runner import device_pipeline as dp

    calls = []
    monkeypatch.setattr(dp, "make_sharded_eval_step",
                        lambda *a, **k: (lambda shard, audio, nv: calls.append(audio.shape)))
    ctx = SimpleNamespace(record=Record(), ranges={})
    patches = harness.Patches()
    dataset_stats.instrument(ctx, patches)
    step = dp.make_sharded_eval_step(None, None, None, 12)
    step(None, np.zeros((4, 100), np.float32), np.array([100, 60, 30, 1], np.int32))
    step(None, np.zeros((4, 50), np.float32), np.array([50, 50, 50, 50], np.int32))
    patches.undo()
    assert calls == [(4, 100), (4, 50)]
    c = ctx.record.counters
    assert (c["steps"], c["rows"], c["bucket_samples"], c["valid_samples"]) == (2, 8, 600, 391)
    assert pad_share.read(ctx) == pytest.approx(1 - 391 / 600)
    assert dp.make_sharded_eval_step is not step
