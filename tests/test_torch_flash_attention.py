"""Packed flash attention of the PyTorch port against fadtk_tpu on the CPU.

The plain twin (``flash_attention_packed_reference``) is held against the JAX
package's Pallas kernel run in interpret mode and against its XLA attention
core; the CUDA kernel is held against the twin on the card (marked ``cuda``).
Only valid query rows are compared: padded rows are unspecified-but-finite in
every implementation.

JAX is imported inside the tests that use it: the machine with the card has
no JAX, and runs the ``cuda`` test there with
``python -m pytest --noconftest tests/test_torch_flash_attention.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.ops import flash_attention as fa

# f32: the online softmax reorders the sums (~1e-6 relative at these sizes).
# bf16: p is rounded to bf16 before p·v in both, but the products accumulate
# in a different order, so outputs of magnitude ~1 differ by about one bf16 ulp.
ATOL = {"float32": 3e-6, "bfloat16": 2e-2}


def _inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h * d)).astype(np.float32) for _ in range(3)]


def _valid_rows_close(got, want, nv, atol):
    for i, n in enumerate(nv):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,nv", [
    (4, 100, 2, [1, 64, 65, 100]),
    (2, 130, 3, [130, 7]),
])
def test_twin_matches_pallas_interpret(dtype, b, t, h, nv):
    import jax.numpy as jnp

    from fadtk_tpu.ops.flash_attention import flash_attention_packed as jax_packed

    q, k, v = _inputs(b, t, h, 64, seed=t)
    jdt = jnp.dtype(dtype)
    want = jax_packed(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(nv, jnp.int32),
        num_heads=h, interpret=True,
    )
    tdt = getattr(torch, dtype)
    got = fa.flash_attention_packed_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.tensor(nv), num_heads=h
    )
    assert got.dtype == tdt and got.shape == (b, t, h * 64)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    _valid_rows_close(got, np.asarray(want, np.float32), nv, ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_xla_attention_core(dtype):
    """Against the encoder's plain attention with the additive key mask it
    builds from the frame mask (fadtk_tpu encoder.py:436-438)."""
    import jax.numpy as jnp

    from fadtk_tpu.models.speech.encoder import _attention_core, _split_heads

    b, t, h, nv = 3, 77, 4, [77, 30, 1]
    q, k, v = _inputs(b, t, h, 64, seed=5)
    jdt = jnp.dtype(dtype)
    mask = (np.arange(t)[None, :] < np.asarray(nv)[:, None]).astype(np.float32)
    key_bias = jnp.asarray((1.0 - mask)[:, None, None, :], jdt) * jnp.finfo(jdt).min
    want = _attention_core(*(_split_heads(jnp.asarray(x, jdt), h) for x in (q, k, v)), key_bias)
    tdt = getattr(torch, dtype)
    got = fa.flash_attention_packed_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.tensor(nv), num_heads=h
    )
    _valid_rows_close(got.float().numpy(), np.asarray(want, np.float32), nv, ATOL[dtype])


def test_wrapper_routes_cpu_tensors_to_the_twin():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 50, 2, 64, seed=1))
    nv = torch.tensor([50, 3])
    before = fa.flash_attention_packed.launches
    got = fa.flash_attention_packed(q, k, v, nv, num_heads=2)
    want = fa.flash_attention_packed_reference(q, k, v, nv, num_heads=2)
    assert torch.equal(got, want)
    assert fa.flash_attention_packed.launches == before  # only kernel launches count
    # n_valid=None means every key is valid; n_valid beyond T clamps to T.
    assert torch.equal(fa.flash_attention_packed_reference(q, k, v, None, num_heads=2),
                       fa.flash_attention_packed_reference(q, k, v, torch.tensor([50, 99]),
                                                           num_heads=2))


def test_wrapper_rejects_other_devices():
    q = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_packed(q, q, q, None, num_heads=1)


def test_flash_enabled_by_device_and_env(monkeypatch):
    monkeypatch.delenv("FADTK_TPU_FLASH_ATTENTION", raising=False)
    assert fa.flash_attention_enabled(torch.device("cuda"))
    assert not fa.flash_attention_enabled(torch.device("cpu"))
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "on")
    assert fa.flash_attention_enabled(torch.device("cpu"))
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "0")
    assert not fa.flash_attention_enabled(torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t", [("bfloat16", 499), ("float32", 499), ("bfloat16", 749)])
def test_kernel_matches_twin_on_card(dtype, t):
    """The hand-written CUDA kernel vs the twin at the main path's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    b, h = 16, 12
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dev, tdt) for x in _inputs(b, t, h, 64, seed=t))
    nv_list = [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
    nv = torch.tensor(nv_list, dtype=torch.int32, device=dev)
    before = fa.flash_attention_packed.launches
    got = fa.flash_attention_packed(q, k, v, nv, num_heads=h)
    want = fa.flash_attention_packed_reference(q, k, v, nv, num_heads=h)
    torch.cuda.synchronize()
    assert fa.flash_attention_packed.launches == before + 1
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    _valid_rows_close(got, want, nv_list, {"float32": 1e-5, "bfloat16": 2e-2}[dtype])
    for i, n in enumerate(nv_list):
        dead = -(-n // 64) * 64  # fully padded 64-row query tiles are exact zeros
        assert (got[i, dead:] == 0).all()
