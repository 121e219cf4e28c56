"""The factorized-bias form of the port's packed flash attention (WavLM's
gated relative-position bias) against fadtk_tpu on the CPU.

The plain twin with ``position_bias`` (H, T, T) and ``gate`` (B, T, H) is held
against the JAX package's Pallas kernel with the same operands, run in
interpret mode, and against the dense gated-bias ``_attention_core`` that
WavLM's XLA path uses; the CUDA kernel is held against the twin on the card
(marked ``cuda``). Only valid query rows are compared: padded rows are
unspecified-but-finite in every implementation.

JAX is imported inside the tests that use it: the machine with the card has
no JAX, and runs the ``cuda`` test there with
``python -m pytest --noconftest tests/test_torch_flash_attention_bias.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.ops import flash_attention as fa

# f32: the online softmax and the bias add reorder the sums (~1e-6 relative).
# bf16: p is rounded to bf16 before p·v in all of them, at different scales
# and in a different order, so outputs differ by about one bf16 ulp.
ATOL = {"float32": 3e-6, "bfloat16": 2e-2}
CASES = [  # b, t, h, n_valid: ragged, including 1, T not a multiple of 64
    (3, 100, 2, [1, 64, 100]),
    (2, 130, 3, [130, 7]),
]


def _inputs(b, t, h, seed):
    """q, k, v (B, T, H*64) standard normal; pb (H, T, T) standard normal;
    gate (B, T, H) uniform in [1, 3] (tests/test_flash_attention.py)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h * 64)).astype(np.float32) for _ in range(3))
    pb = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (b, t, h)).astype(np.float32)
    return q, k, v, pb, gate


def _twin(q, k, v, nv, pb, gate, h, dtype):
    tdt = getattr(torch, dtype)
    out = fa.flash_attention_packed_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.tensor(nv),
        torch.from_numpy(pb), torch.from_numpy(gate), num_heads=h,
    )
    assert out.dtype == tdt and out.shape == q.shape
    out = out.float().numpy()
    assert np.isfinite(out).all()
    return out


def _valid_rows_close(got, want, nv, atol):
    for i, n in enumerate(nv):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,nv", CASES)
def test_bias_twin_matches_pallas_interpret(dtype, b, t, h, nv):
    import jax.numpy as jnp

    from fadtk_tpu.ops.flash_attention import flash_attention_packed as jax_packed

    q, k, v, pb, gate = _inputs(b, t, h, seed=t)
    jdt = jnp.dtype(dtype)
    want = jax_packed(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(nv, jnp.int32),
        jnp.asarray(pb), jnp.asarray(gate), num_heads=h, interpret=True,
    )
    got = _twin(q, k, v, nv, pb, gate, h, dtype)
    _valid_rows_close(got, np.asarray(want, np.float32), nv, ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,nv", CASES)
def test_bias_twin_matches_dense_gated_core(dtype, b, t, h, nv):
    """Against WavLM's plain path: ``_attention_core`` with the dense
    ``gate[..., None] * pb + key_bias`` (fadtk_tpu encoder.py:328-331), the
    bias kept in float32 as the kernel route gets it."""
    import jax.numpy as jnp

    from fadtk_tpu.models.speech.encoder import _attention_core, _split_heads

    q, k, v, pb, gate = _inputs(b, t, h, seed=t + 1)
    jdt = jnp.dtype(dtype)
    mask = (np.arange(t)[None, :] < np.asarray(nv)[:, None]).astype(np.float32)
    key_bias = (1.0 - mask)[:, None, None, :] * np.finfo(np.float32).min
    dense = gate.transpose(0, 2, 1)[..., None] * pb[None] + key_bias  # (B, H, T, T)
    want = _attention_core(
        *(_split_heads(jnp.asarray(x, jdt), h) for x in (q, k, v)), jnp.asarray(dense)
    )
    got = _twin(q, k, v, nv, pb, gate, h, dtype)
    _valid_rows_close(got, np.asarray(want, np.float32), nv, ATOL[dtype])


def test_bias_operands_come_together_and_cpu_runs_the_twin():
    q, k, v, pb, gate = (torch.from_numpy(x) for x in _inputs(2, 70, 2, seed=3))
    nv = torch.tensor([70, 9])
    with pytest.raises(ValueError, match="come together"):
        fa.flash_attention_packed(q, k, v, nv, pb, None, num_heads=2)
    with pytest.raises(ValueError, match="come together"):
        fa.flash_attention_packed_reference(q, k, v, nv, None, gate, num_heads=2)
    before = (fa.flash_attention_packed.launches, fa.flash_attention_packed.bias_launches)
    got = fa.flash_attention_packed(q, k, v, nv, pb, gate, num_heads=2)
    assert torch.equal(got, fa.flash_attention_packed_reference(q, k, v, nv, pb, gate,
                                                                 num_heads=2))
    # The bias changes the result, and a zero bias gives the no-bias twin.
    assert not torch.equal(got, fa.flash_attention_packed_reference(q, k, v, nv, num_heads=2))
    zero = fa.flash_attention_packed_reference(q, k, v, nv, torch.zeros_like(pb), gate,
                                               num_heads=2)
    torch.testing.assert_close(zero, fa.flash_attention_packed_reference(q, k, v, nv,
                                                                         num_heads=2))
    assert (fa.flash_attention_packed.launches,
            fa.flash_attention_packed.bias_launches) == before  # CPU: no kernel launch


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h", [("bfloat16", 12), ("float32", 12), ("bfloat16", 16)])
def test_bias_kernel_matches_twin_on_card(dtype, h):
    """The hand-written CUDA kernel's bias form vs the twin at the main path's
    shapes (wavlm-base-plus H=12, wavlm-large H=16; 16 kHz 10 s bucket)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    b, t = 16, 499
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    q, k, v, pb, gate = _inputs(b, t, h, seed=t + h)
    q, k, v = (torch.from_numpy(x).to(dev, tdt) for x in (q, k, v))
    pb, gate = torch.from_numpy(pb).to(dev), torch.from_numpy(gate).to(dev)
    nv_list = [1, 64, 65, t, t - 1, 128, 2, 200, 63, t, 129, 300, t // 2, 450, 191, t]
    nv = torch.tensor(nv_list, dtype=torch.int32, device=dev)
    before = fa.flash_attention_packed.bias_launches
    got = fa.flash_attention_packed(q, k, v, nv, pb, gate, num_heads=h)
    want = fa.flash_attention_packed_reference(q, k, v, nv, pb, gate, num_heads=h)
    torch.cuda.synchronize()
    assert fa.flash_attention_packed.bias_launches == before + 1
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    _valid_rows_close(got, want, nv_list, {"float32": 1e-5, "bfloat16": 2e-2}[dtype])
    for i, n in enumerate(nv_list):
        dead = -(-n // 64) * 64  # fully padded 64-row query tiles are exact zeros
        assert (got[i, dead:] == 0).all()
    with pytest.raises(ValueError, match="position_bias must be float32"):
        fa.flash_attention_packed(q, k, v, nv, pb.to(tdt if tdt != torch.float32
                                                     else torch.float64), gate, num_heads=h)
