"""Whole runs of the harness on the CPU at a tiny size: a sound run is
correct, and a run with the timed path broken underneath is not, once for
each fault these cells can have. Also: no result without a card, and none
in a tree that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tiny import REPO, RUN, make_root, run_ranks, run_tiny


def state_unchanged(patch):
    """The Welford merge hands back the state it was given."""
    from fadtk_tpu_torch.runner import device_pipeline as dp

    merge = dp.merge_partial_stats_device
    patch(dp, "merge_partial_stats_device",
          lambda state, *a, **k: merge(state, *a, **k) if state is None else state)


def _wrap_step(patch, change):
    from fadtk_tpu_torch.runner import device_pipeline as dp

    make = dp.make_sharded_eval_step

    def made(*a, **k):
        step = make(*a, **k)
        return lambda shard, audio, num_valid: step(shard, *change(audio.copy(),
                                                                   num_valid.copy()))

    patch(dp, "make_sharded_eval_step", made)


def half_the_batch(patch):
    """Half of each batch's rows never reach the model; the mean is over the
    rest."""
    def change(audio, num_valid):
        h = audio.shape[0] // 2
        audio[h:] = 0
        num_valid[h:] = 1
        return audio, num_valid

    _wrap_step(patch, change)


def an_answer_altered(patch):
    """One clip's answer altered where it is produced: a row embeds another
    row's audio (the frame count stays the same)."""
    def change(audio, num_valid):
        audio[1] = audio[0]
        return audio, num_valid

    _wrap_step(patch, change)


def no_exchange(patch):
    """The merge of statistics across the data-parallel ranks left out."""
    from fadtk_tpu_torch.parallel import tp

    patch(tp, "welford_merge_across", lambda state, group=None: state)


FAULTS = {"state unchanged": state_unchanged, "half the batch": half_the_batch,
          "an answer altered": an_answer_altered, "no exchange": no_exchange}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("one"))


def test_a_sound_run_is_correct(tmp_path, root, monkeypatch, capsys):
    from portbench import run

    result = run_tiny(tmp_path, root, monkeypatch)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == {"embed_audio_s_per_s", "setup_s"}
    assert result["compared"]["n_mismatch"] == {"value": 0.0, "limit": 0.0}
    assert run.emit(result) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert err.rstrip().splitlines()[-1].startswith("compared cov_err ")


def test_a_traced_run_reads_the_per_layer_metrics(tmp_path, root, monkeypatch):
    result = run_tiny(tmp_path, root, monkeypatch, trace=True)
    assert result["correct"]
    m = result["metrics"]
    # On the CPU there is no device trace: its metrics are left out.
    assert {"loader_wait_share", "pad_share", "mfu"} <= set(m)
    assert m["pad_share"]["value"] == pytest.approx(0.9, abs=1e-6)  # 1 s clips in 10 s buckets
    assert "embed_audio_s_per_s" not in m


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "an answer altered"])
def test_a_fault_is_not_correct(tmp_path, root, monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    result = run_tiny(tmp_path, root, monkeypatch)
    assert result["correct"] is False and result["failed"] >= 1
    if fault == "an answer altered":
        assert result["compared"]["n_mismatch"]["value"] == 0.0  # caught by the limits


def test_two_ranks_sound_and_without_the_exchange(tmp_path):
    root = make_root(tmp_path, chips=2)
    result, err = run_ranks(tmp_path, root, 2)
    assert result is not None, err[-3000:]
    assert result["correct"] and result["device"]["count"] == 2
    result, err = run_ranks(tmp_path, root, 2, faults=("no exchange",), seed=2**31 + 8)
    assert result is not None, err[-3000:]
    assert result["correct"] is False


def test_no_result_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(RUN), "--workload", "w2v2-base.songs", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env={**os.environ, "TMPDIR": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_in_a_tree_of_the_benchmark_alone(tmp_path, root):
    """Past the look for a card, a run in a tree that holds only the
    benchmark fails for want of the program."""
    tree = tmp_path / "tree"
    tree.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", tree)
    shutil.copytree(REPO / "portbench", tree / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); from pathlib import Path; "
            "from portbench import harness, run; "
            f"r = harness.run_cell('tiny.cell', 1, 1.0, False, pool_dir=Path({str(tmp_path / 'p')!r}), "
            f"t_start=time.time(), cpu=True, root=Path({str(root)!r})); sys.exit(run.emit(r))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd=tree, env={**env, "TMPDIR": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "fadtk_tpu_torch" in p.stderr
