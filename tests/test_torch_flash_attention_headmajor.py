"""The head-major flash attention of the PyTorch port (K2) against fadtk_tpu
on the CPU.

The plain twin (``flash_attention_reference``) is held against the JAX
package's ``flash_attention`` run in interpret mode, with and without WavLM's
factorized bias and in its per-(b, h) and grouped grids, and against the
packed twin on the transposed tensors; the CUDA kernel is held against the
twin on the card (marked ``cuda``), in every form and through the strided
head-split views of packed tensors. Only valid query rows are compared:
padded rows are unspecified-but-finite in every implementation.

JAX is imported inside the tests that use it: the machine with the card has
no JAX, and runs the ``cuda`` tests there with
``python -m pytest --noconftest tests/test_torch_flash_attention_headmajor.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.ops import flash_attention as fa

# The K1b test tolerances. f32: the online softmax and the bias add reorder
# the sums (~1e-6 relative). bf16: p is rounded to bf16 before p·v in all of
# them, at different scales and in a different order, so outputs differ by
# about one bf16 ulp.
ATOL = {"float32": 3e-6, "bfloat16": 2e-2}
# (b, t, h, n_valid, JAX block size or None for its adaptive choice): ragged
# n_valid including 1 and T; T=130 is one JAX block, T=300 with 128-row
# blocks three.
CASES = [
    (3, 130, 2, [1, 130, 64], None),
    (2, 300, 2, [300, 129], 128),
]


def _inputs(b, t, h, seed):
    """q, k, v (B, H, T, 64) standard normal; pb (H, T, T) standard normal;
    gate (B, H, T) uniform in [1, 3]."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, 64)).astype(np.float32) for _ in range(3))
    pb = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (b, h, t)).astype(np.float32)
    return q, k, v, pb, gate


def _valid_rows_close(got, want, nv, atol):
    for i, n in enumerate(nv):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "grouped", "bias"])
@pytest.mark.parametrize("b,t,h,nv,block", CASES)
def test_twin_matches_pallas_interpret(dtype, form, b, t, h, nv, block):
    import jax.numpy as jnp

    from fadtk_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v, pb, gate = _inputs(b, t, h, seed=t + len(form))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    bias = form == "bias"
    want = jax_flash(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(nv, jnp.int32),
        block_q=block, block_kv=block, interpret=True,
        position_bias=jnp.asarray(pb) if bias else None,
        gate=jnp.asarray(gate) if bias else None, grouped=form == "grouped",
    )
    got = fa.flash_attention_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.tensor(nv),
        torch.from_numpy(pb) if bias else None, torch.from_numpy(gate) if bias else None,
    )
    assert got.dtype == tdt and got.shape == (b, h, t, 64)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    _valid_rows_close(got, np.asarray(want, np.float32), nv, ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_twin_matches_packed_twin_transposed(dtype, bias):
    """K2's twin on (B, H, T, D) equals K1's twin on the packed (B, T, H*D)
    transposes, bit for bit: the same function in the other layout."""
    b, t, h, nv = 2, 90, 3, [90, 17]
    q, k, v, pb, gate = (torch.from_numpy(x) for x in _inputs(b, t, h, seed=11))
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    extra = (pb, gate) if bias else (None, None)
    got = fa.flash_attention_reference(q, k, v, torch.tensor(nv), *extra)

    def packed(x):
        return x.transpose(1, 2).reshape(b, t, h * 64)

    want = fa.flash_attention_packed_reference(
        packed(q), packed(k), packed(v), torch.tensor(nv),
        pb if bias else None, gate.transpose(1, 2) if bias else None, num_heads=h,
    )
    assert torch.equal(packed(got), want)


def test_wrapper_routes_cpu_tensors_to_the_twin(monkeypatch):
    """CPU tensors take the twin whatever ``grouped`` or the env say, and no
    launch is counted; the bias operands come together."""
    q, k, v, pb, gate = (torch.from_numpy(x) for x in _inputs(2, 70, 2, seed=3))
    nv = torch.tensor([70, 9])
    counts = (fa.flash_attention.launches, fa.flash_attention.bias_launches,
              fa.flash_attention.grouped_launches)
    monkeypatch.setenv("FADTK_TPU_FLASH_GROUPED", "1")
    for extra in ((None, None), (pb, gate)):
        assert torch.equal(fa.flash_attention(q, k, v, nv, *extra),
                           fa.flash_attention_reference(q, k, v, nv, *extra))
    assert torch.equal(fa.flash_attention(q, k, v, nv, grouped=False),
                       fa.flash_attention(q, k, v, nv, grouped=True))
    assert (fa.flash_attention.launches, fa.flash_attention.bias_launches,
            fa.flash_attention.grouped_launches) == counts
    with pytest.raises(ValueError, match="come together"):
        fa.flash_attention(q, k, v, nv, pb, None)
    with pytest.raises(ValueError, match="come together"):
        fa.flash_attention_reference(q, k, v, nv, None, gate)
    # n_valid=None means every key is valid; n_valid beyond T clamps to T,
    # 0 clamps to 1.
    assert torch.equal(fa.flash_attention(q, k, v, None),
                       fa.flash_attention(q, k, v, torch.tensor([70, 99])))
    assert torch.equal(fa.flash_attention(q, k, v, torch.tensor([0, 5])),
                       fa.flash_attention(q, k, v, torch.tensor([1, 5])))


def test_twin_takes_strided_views():
    """The twin reads head-split views of packed tensors as they are."""
    b, t, h = 2, 40, 3
    rng = np.random.default_rng(5)
    packed = [torch.from_numpy(rng.standard_normal((b, t, h * 64)).astype(np.float32))
              for _ in range(3)]
    views = [x.view(b, t, h, 64).transpose(1, 2) for x in packed]
    assert not views[0].is_contiguous()
    nv = torch.tensor([40, 12])
    assert torch.equal(fa.flash_attention(*views, nv),
                       fa.flash_attention(*(x.contiguous() for x in views), nv))


def test_wrapper_rejects_other_devices():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, None)


# --------------------------------------------------------------------------- #
# The kernel on the card
# --------------------------------------------------------------------------- #

NV_CARD = [1, 64, 65, 499, 498, 128, 2, 200, 63, 499, 129, 300, 249, 450, 191, 499]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,form,strided", [
    ("bfloat16", 12, "bias", False), ("bfloat16", 16, "bias", False),
    ("bfloat16", 6, "bias", False), ("float32", 12, "bias", False),
    ("bfloat16", 12, "plain", False), ("float32", 12, "plain", False),
    ("bfloat16", 12, "grouped", False), ("float32", 12, "grouped", False),
    ("bfloat16", 12, "bias", True), ("bfloat16", 12, "plain", True),
])
def test_kernel_matches_twin_on_card(dtype, h, form, strided):
    """K2 vs its twin at the main path's shapes (B=16, T=499; H=12
    wavlm-base-plus, 16 wavlm-large, 6 a tp=2 shard), with ``strided`` through
    the head-split views of packed (B, T, H*D) tensors as the tensor-parallel
    path passes them. Fully padded 64-row query tiles are exact zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    b, t = 16, 499
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    q, k, v, pb, gate = _inputs(b, t, h, seed=t + h)
    if strided:
        q, k, v = (torch.from_numpy(x).to(dev, tdt).transpose(1, 2).contiguous()
                   .transpose(1, 2) for x in (q, k, v))
        assert not q.is_contiguous()
    else:
        q, k, v = (torch.from_numpy(x).to(dev, tdt) for x in (q, k, v))
    extra = (torch.from_numpy(pb).to(dev), torch.from_numpy(gate).to(dev)) \
        if form == "bias" else (None, None)
    nv = torch.tensor(NV_CARD, dtype=torch.int32, device=dev)
    counter = {"bias": "bias_launches", "grouped": "grouped_launches",
               "plain": "launches"}[form]
    before = getattr(fa.flash_attention, counter)
    got = fa.flash_attention(q, k, v, nv, *extra, grouped=form == "grouped")
    want = fa.flash_attention_reference(q, k, v, nv, *extra)
    torch.cuda.synchronize()
    assert getattr(fa.flash_attention, counter) == before + 1
    assert got.dtype == tdt and got.shape == (b, h, t, 64)
    assert got.stride() == q.stride()  # the output takes q's layout
    assert torch.isfinite(got.float()).all()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    _valid_rows_close(got, want, NV_CARD, {"float32": 1e-5, "bfloat16": 2e-2}[dtype])
    for i, n in enumerate(NV_CARD):
        dead = -(-n // 64) * 64
        assert (got[i, :, dead:] == 0).all()


@pytest.mark.cuda
def test_kernel_strided_equals_contiguous_on_card():
    """The same values through the strided views and contiguous copies give
    the same output bit for bit (same tiles, same order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    b, t, h = 4, 300, 12
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    packed = [torch.from_numpy(rng.standard_normal((b, t, h * 64)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(3)]
    views = [x.view(b, t, h, 64).transpose(1, 2) for x in packed]
    nv = torch.tensor([300, 1, 77, 200], dtype=torch.int32, device=dev)
    got = fa.flash_attention(*views, nv)
    want = fa.flash_attention(*(x.contiguous() for x in views), nv)
    assert torch.equal(got, want)
    bad = torch.zeros((b, h, t, 68), device=dev, dtype=torch.bfloat16)[..., :64]  # 136 B rows
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        fa.flash_attention(bad, bad, bad, nv)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "head-major", "strided"])
@pytest.mark.parametrize("form", ["plain", "bias", "grouped"])
@pytest.mark.parametrize("t", [499, 512])
def test_kernel_at_tile_edges_on_card(t, form, layout):
    """Every bf16 form at the n_valid that sit on the 64-key tile edges (1,
    63, 64, 65, 127, 128, T-1, T), at T = 499 and at T = 512, a multiple of
    the tile, in the packed layout (K1, K1b), head-major (K2) and through
    the head-split views of packed tensors. The grouped grid is head-major
    only (the packed entry has none): its packed case runs the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    b, h = 8, 12
    dev = torch.device("cuda")
    nv_list = [1, 63, 64, 65, 127, 128, t - 1, t]
    nv = torch.tensor(nv_list, dtype=torch.int32, device=dev)
    q, k, v, pb, gate = _inputs(b, t, h, seed=t + len(form))
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in (q, k, v))
    pb, gate = torch.from_numpy(pb).to(dev), torch.from_numpy(gate).to(dev)
    bias = form == "bias"
    if layout == "packed":
        q, k, v = (x.transpose(1, 2).reshape(b, t, h * 64).contiguous() for x in (q, k, v))
        extra = (pb, gate.transpose(1, 2).contiguous()) if bias else (None, None)
        got = fa.flash_attention_packed(q, k, v, nv, *extra, num_heads=h)
        want = fa.flash_attention_packed_reference(q, k, v, nv, *extra, num_heads=h)
        got, want = (x.view(b, t, h, 64).transpose(1, 2) for x in (got, want))
    else:
        if layout == "strided":
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        extra = (pb, gate) if bias else (None, None)
        got = fa.flash_attention(q, k, v, nv, *extra, grouped=form == "grouped")
        want = fa.flash_attention_reference(q, k, v, nv, *extra)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    _valid_rows_close(got, want, nv_list, ATOL["bfloat16"])
    for i, n in enumerate(nv_list):
        dead = -(-n // 64) * 64
        assert (got[i, :, dead:] == 0).all()
