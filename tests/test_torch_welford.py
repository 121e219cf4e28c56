"""The device half of the port's statistics (masked Welford/Chan, on the
tensors' device) against fadtk_tpu.metric.stats on the CPU.

Each function gets the same numpy inputs (float32, from a seed) in both
packages. Tolerance: relative 1e-6 in float32 (the two frameworks sum in
other orders; the covariance's matrix product is one float32 GEMM in each).
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.metric import stats as ts

from test_torch_tp import run_gloo

RTOL = 1e-6
D = 24


def _close(got, want, rtol=RTOL):
    """|got - want| <= rtol · max|want| (elementwise rtol is meaningless at
    cancelled entries of a covariance)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def _batch(n, seed, offset=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)) * 2.0 + offset).astype(np.float32)


MASKS = {
    "none": None,
    "ragged": lambda n: (np.arange(n) % 3 != 1).astype(np.float32),
    "all_zero": lambda n: np.zeros(n, np.float32),
    "one": lambda n: (np.arange(n) == 4).astype(np.float32),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_batch_moments_match_jax(mask):
    import jax.numpy as jnp

    from fadtk_tpu.metric import stats as js

    x = _batch(37, seed=1)
    m = None if MASKS[mask] is None else MASKS[mask](37)
    want = js._batch_moments(jnp.asarray(x), None if m is None else jnp.asarray(m), jnp.float32)
    got = ts._batch_moments(torch.from_numpy(x), None if m is None else torch.from_numpy(m),
                            torch.float32)
    assert float(got.n) == float(want.n)
    for g, w in ((got.mu, want.mu), (got.m2, want.m2)):
        if mask == "all_zero":  # empty batch: exact zeros, no NaN
            assert not g.any()
        else:
            _close(g.numpy(), w)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_update_merge_finalize_match_jax(mask):
    """A chain of updates (the second batch masked as named) and the
    finalized (mu, cov), including n = 1 ('one' after an all-zero start)."""
    import jax.numpy as jnp

    from fadtk_tpu.metric import stats as js

    xs = [_batch(20, seed=2), _batch(31, seed=3, offset=-1.0), _batch(9, seed=4)]
    masks = [None, None if MASKS[mask] is None else MASKS[mask](31), np.ones(9, np.float32)]
    if mask == "one":  # start empty, so the state passes through n = 1
        masks[0] = np.zeros(20, np.float32)
        masks[2] = np.zeros(9, np.float32)
    js_state, ts_state = js.welford_init(D), ts.welford_init(D)
    for x, m in zip(xs, masks):
        js_state = js.welford_update(js_state, jnp.asarray(x), None if m is None else jnp.asarray(m))
        ts_state = ts.welford_update(ts_state, torch.from_numpy(x),
                                     None if m is None else torch.from_numpy(m))
        assert float(ts_state.n) == float(js_state.n)
        _close(ts_state.mu.numpy(), js_state.mu)
        _close(ts_state.m2.numpy(), js_state.m2)
    mu, cov = ts.welford_finalize(ts_state)
    want_mu, want_cov = js.welford_finalize(js_state)
    _close(mu.numpy(), want_mu)
    if float(js_state.n) > 1:
        _close(cov.numpy(), want_cov)
    else:
        assert not cov.any() and np.asarray(want_cov).max() == 0.0


def test_welford_merge_matches_jax_and_zero_count_is_exact():
    import jax.numpy as jnp

    from fadtk_tpu.metric import stats as js

    a_np = [_batch(15, 5), _batch(8, 6)]
    ja = js.welford_update(js.welford_init(D), jnp.asarray(a_np[0]))
    jb = js.welford_update(js.welford_init(D), jnp.asarray(a_np[1]))
    ta = ts.welford_update(ts.welford_init(D), torch.from_numpy(a_np[0]))
    tb = ts.welford_update(ts.welford_init(D), torch.from_numpy(a_np[1]))
    got, want = ts.welford_merge(ta, tb), js.welford_merge(ja, jb)
    assert float(got.n) == float(want.n) == 23.0
    _close(got.mu.numpy(), want.mu)
    _close(got.m2.numpy(), want.m2)
    # A zero-count partial leaves the state bit for bit as it was.
    empty = ts.welford_init(D)
    for merged in (ts.welford_merge(ta, empty), ts.welford_merge(empty, ta)):
        assert torch.equal(merged.mu, ta.mu) and torch.equal(merged.m2, ta.m2)
        assert float(merged.n) == 15.0


@pytest.mark.parametrize("b_is_cov", [False, True])
def test_merge_partial_stats_device_matches_jax(b_is_cov):
    """The running (mu, M2, n) chain over three partials, one of them empty
    (n = 0) and one a single frame (n = 1), from ``state=None``."""
    import jax.numpy as jnp

    from fadtk_tpu.metric import stats as js

    parts = []
    for i, n in enumerate((12, 0, 1, 30)):
        x = _batch(max(n, 1), seed=10 + i)[:n]
        mu = x.mean(axis=0) if n else np.zeros(D, np.float32)
        xc = x - mu
        m2 = (xc.T @ xc).astype(np.float32)
        second = m2 / max(n - 1, 1) if b_is_cov else m2
        parts.append((mu.astype(np.float32), second.astype(np.float32), np.float32(n)))
    js_state = ts_state = None
    for mu, second, n in parts:
        js_state = js.merge_partial_stats_device(
            js_state, jnp.asarray(mu), jnp.asarray(second), jnp.asarray(n), b_is_cov=b_is_cov)
        ts_state = ts.merge_partial_stats_device(
            ts_state, torch.from_numpy(mu), torch.from_numpy(second), torch.tensor(n),
            b_is_cov=b_is_cov)
    assert float(ts_state[2]) == float(js_state[2]) == 43.0
    _close(ts_state[0].numpy(), js_state[0])
    _close(ts_state[1].numpy(), js_state[1])
    # The host float64 chain agrees to float32 accumulation.
    mu, s, n = np.zeros(D), np.zeros((D, D)), 0
    for p_mu, second, p_n in parts:
        if p_n:
            m2 = second * max(p_n - 1, 1) if b_is_cov else second
            mu, s, n = ts.merge_partial_stats(mu, s, n, p_mu.astype(np.float64),
                                              m2.astype(np.float64), int(p_n))
    _close(ts_state[1].numpy(), s, rtol=1e-5)


def test_merge_across_is_identity_without_a_group():
    st = ts.welford_update(ts.welford_init(D), torch.from_numpy(_batch(10, 1)))
    assert ts.welford_merge_across(st, None) is st


def test_batch_moments_keep_matmuls_in_float32():
    """TF32 stays off for the covariance's product: it is the default, and
    ``_batch_moments`` sets it again."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ts._batch_moments(torch.ones((3, D)), None, torch.float32)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.metric import stats as ts

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
rng = np.random.default_rng(rank)
n = [17, 0, 5][rank]
x = torch.from_numpy((rng.standard_normal((max(n, 1), 24)) + rank).astype(np.float32)[:n])
st = ts.welford_update(ts.welford_init(24), x, torch.ones(n))  # masked: n = 0 is exact
merged = ts.welford_merge_across(st, dist.group.WORLD)
np.savez(f"{out}/rank{rank}.npz", mu=merged.mu.numpy(), m2=merged.m2.numpy(),
         n=merged.n.numpy(), x=x.numpy())
dist.destroy_process_group()
"""


def test_merge_across_three_gloo_ranks(tmp_path):
    """Three gloo processes (one with no frames): every rank ends with the
    Chan merge of all partials, equal to the statistics of all frames."""
    run_gloo(WORKER, tmp_path, world=3)
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(3)]
    frames = np.concatenate([r["x"] for r in res]).astype(np.float64)
    xc = frames - frames.mean(axis=0)
    for r in res:
        assert float(r["n"]) == frames.shape[0] == 22
        _close(r["mu"], frames.mean(axis=0))
        _close(r["m2"], xc.T @ xc, rtol=1e-5)
        np.testing.assert_array_equal(r["m2"], res[0]["m2"])
