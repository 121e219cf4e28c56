"""The control on the card: the reference computed in TF32 (the precision
below the configurations' float32), in the program's place, fails the
limits that the program's runs meet. Full widths (w2v2-base), a few short
pool clips so that a test run holds it. Skips without a card."""

import dataclasses
import json

import numpy as np
import pytest

from portbench import compare, manifest, traffic
from portbench.families import speech
from portbench.reference.gaussian import dataset_gaussian


@pytest.mark.cuda
def test_the_control_fails_the_limits(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = manifest.config(manifest.load(), "w2v2-base")
    limits = compare.load_limits("w2v2-base.songs")
    t = traffic.load_traffic("songs")
    t = dataclasses.replace(t, spec=dict(t.spec, pool_files=8,
                                         lengths={"kind": "fixed", "seconds": 3.0}))
    for seed in (11, 2**31 + 12, 2**33 + 13):
        files, _ = traffic.write_pool(t, seed, tmp_path / str(seed), dev)
        w = speech.make_weights(cfg, seed, dev)
        ref = speech.reference_moments(cfg, w, files, dev)
        low = speech.reference_moments(cfg, w, files, dev, tf32=True)
        counts = np.full(len(files), 2)
        numbers = compare.compare_call(*dataset_gaussian(low, counts), *dataset_gaussian(ref, counts))
        assert numbers["n_mismatch"] == 0
        assert not compare.within(numbers, limits), (seed, numbers, limits)
