"""The traffic generator: deterministic by seed, the stated lengths, rate and
channels, the same set of lengths on every seed, and calls that hold each
pool file equally often."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference.audio import read_wav

SEEDS = (0, 2**31 + 11, 2**40 + 3)


def small(name, **spec):
    t = traffic.load_traffic(name)
    return dataclasses.replace(t, spec=dict(t.spec, **spec))


def test_length_set_is_the_same_on_every_seed():
    t = traffic.load_traffic("songs")
    sets = [np.sort(traffic.pool_lengths(t, s)) for s in SEEDS]
    for x in sets[1:]:
        np.testing.assert_array_equal(x, sets[0])
    assert not np.array_equal(traffic.pool_lengths(t, SEEDS[0]), traffic.pool_lengths(t, SEEDS[1]))


def test_songs_lengths_are_log_uniform_4_to_60_s():
    t = traffic.load_traffic("songs")
    sec = traffic.length_grid(t) / t.source_rate
    assert 4.0 < sec.min() < 4.1 and 59.0 < sec.max() < 60.0
    assert abs(np.mean(np.log(sec)) - np.log(np.sqrt(4 * 60))) < 1e-3
    assert 20.0 < sec.mean() < 21.0


def test_fixed_lengths_are_exact_at_44_1_khz_stereo():
    t = small("songs", lengths={"kind": "fixed", "seconds": 10.0})
    assert set(traffic.length_grid(t).tolist()) == {441000}
    assert t.source_rate == 44100 and t.channels == 2


@pytest.mark.parametrize("clips_per_call", [128, 512])
def test_calls_hold_each_file_equally_and_follow_the_seed(clips_per_call):
    t = small("songs", clips_per_call=clips_per_call)
    a = traffic.call_order(t, 5, 3)
    assert a == traffic.call_order(t, 5, 3)
    assert a != traffic.call_order(t, 5, 4)
    assert a != traffic.call_order(t, 6, 3)
    counts = Counter(a)
    assert len(a) == t.clips_per_call and set(counts.values()) == {t.clips_per_call // t.pool_files}


def test_songs_batches_pad_to_the_buckets_of_independent_orders():
    """Files in a seeded order: most batches of 16 pad to the 60 s bucket,
    some to shorter ones, and about 63% of the padded samples are padding."""
    t = traffic.load_traffic("songs")
    for seed in SEEDS:
        lengths = traffic.pool_lengths(t, seed)
        longest, valid, padded = [], 0, 0
        for call in range(5):
            order = traffic.call_order(t, seed, call)
            for g in range(0, len(order), 16):
                group = lengths[order[g:g + 16]] / t.source_rate
                bucket = 10.0 * np.ceil(group.max() / 10.0)
                longest.append(bucket)
                valid += group.sum()
                padded += 16 * bucket
        assert 0.6 < longest.count(60.0) / len(longest) < 0.9
        assert min(longest) < 60.0
        assert 0.60 < 1 - valid / padded < 0.68


def test_written_pool_is_16_bit_stereo_at_the_source_rate(tmp_path):
    t = small("songs", pool_files=4, lengths={"kind": "log_uniform_grid", "min_seconds": 0.2,
                                              "max_seconds": 0.5})
    files, lengths = traffic.write_pool(t, 2**31 + 1, tmp_path / "a", torch.device("cpu"))
    again, _ = traffic.write_pool(t, 2**31 + 1, tmp_path / "b", torch.device("cpu"))
    other, _ = traffic.write_pool(t, 2**31 + 2, tmp_path / "c", torch.device("cpu"))
    for f, g, h, n in zip(files, again, other, lengths):
        raw = f.read_bytes()
        assert raw == g.read_bytes() and raw != h.read_bytes()
        x, sr = read_wav(f)
        assert sr == 44100 and x.shape == (2, n)
        assert 0.05 < np.abs(x).max() < 0.5  # a signal, never clipped
        assert not np.array_equal(x[0], x[1])
    assert not (tmp_path / "a" / "convert").exists()
