"""The port's entry points (``fadtk_tpu_torch/graft_entry.py``) on the CPU:
``entry()`` runs the flagship forward, and ``dryrun_multichip(n)`` runs its
seven paths in one process (n = 1) and over n spawned gloo processes
(n = 2, 4; tp = 2 there). The counterparts of tests/test_graft_entry.py."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)


def test_entry_runs():
    from fadtk_tpu_torch.graft_entry import entry

    fn, args = entry()
    with torch.inference_mode():
        hidden, mask = fn(*args)
    assert hidden.shape[:2] == (13, 2)  # all hidden states, two clips
    assert mask.shape == (2, hidden.shape[2]) and bool(mask[0].all())
    assert not bool(mask[1].all())  # the ragged clip's tail is masked
    assert bool(torch.isfinite(hidden).all())


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n):
    import os

    from fadtk_tpu_torch.graft_entry import dryrun_multichip

    keys = ("FADTK_TPU_RANDOM_WEIGHTS", "FADTK_TPU_FLASH_ATTENTION", "FADTK_TPU_BF16")
    before = {k: os.environ.get(k) for k in keys}
    dryrun_multichip(n)
    assert {k: os.environ.get(k) for k in keys} == before  # restored
