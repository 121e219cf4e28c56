"""The float32 form of the port's flash attention (K1, K1b, K2) as 3xTF32, on the CPU.

The card kernel (``csrc/flash_attention_packed.cu``) takes both products,
q·kᵀ and p·v, three times on TF32 operands split into hi and lo parts
(``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``, float32 accumulation), with S, P and
O in registers. What the CPU can hold of that: a plain-torch emulation of
the body, with its split operands and rounding points, its 64-key tiles and
online softmax, each tile's p·v product summed from zero and added to O, and
its fragment orders (the keys of each 8-key chunk renumbered so that the S
accumulator is P's A operand, V read at the same renumbered rows, and the
output dims in the order the V fragments and the output stores share),
against the float32 twin and against the JAX package's Pallas kernels in
interpret mode, within ``ATOL["float32"]`` of ``chip_smoke.py``, the card
check's bound. A wrong renumbering fails. The kernel itself is held against
the twin on the card by the ``cuda`` tests of
``tests/test_torch_flash_attention*.py``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.ops import flash_attention as fa
from fadtk_tpu_torch.ops.fused_resnet import split_tf32

TOL = 1e-5  # chip_smoke.py's ATOL["float32"]: kernel vs twin on valid rows
BQ = BK = 64
LOG2E = 1.4426950408889634

# A's k8 slot -> key within an 8-key chunk: slot c is key 2c, slot c + 4 key
# 2c + 1 (the m16n8 accumulator gives lane c keys 2c and 2c + 1).
KEY_SLOTS = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
# n8 tile j's slot n -> output dim: 4n + j for j < 4, 32 + 4n + j - 4 above.
DIM_SLOTS = torch.tensor([4 * n + j if j < 4 else 32 + 4 * n + j - 4
                          for j in range(8) for n in range(8)])


def _lane_fragment_orders():
    """The two renumberings as the kernel's lanes realise them, from the
    PTX m16n8k8 fragment layouts: lane (g, c) holds accumulator columns 2c,
    2c + 1 and A slots c, c + 4, and reads V dims 4g .. 4g + 3 (n8 tiles
    0-3) and 32 + 4g .. (tiles 4-7) as B's column g; it stores its
    accumulator columns 2c + e of tile j at dim 8c + 4e + j (j < 4) or
    32 + 8c + 4e + j - 4."""
    key_of_slot, v_dim, store_dim = {}, {}, {}
    for lane in range(32):
        g, c = lane // 4, lane % 4
        key_of_slot[c], key_of_slot[c + 4] = 2 * c, 2 * c + 1
        for j in range(8):
            v_dim[8 * j + g] = 4 * g + j if j < 4 else 32 + 4 * g + j - 4
            for e in range(2):
                store_dim[8 * j + 2 * c + e] = (8 * c + 4 * e + j if j < 4
                                                else 32 + 8 * c + 4 * e + j - 4)
    return ([key_of_slot[s] for s in range(8)], [v_dim[i] for i in range(64)],
            [store_dim[i] for i in range(64)])


def _product(a, b, terms=3):
    """a @ b from split operands: ``terms`` 3 is the kernel's a_lo·b_hi +
    a_hi·b_lo, then + a_hi·b_hi; 1 is one TF32 product."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    big = a_hi @ b_hi
    return big if terms == 1 else (a_lo @ b_hi + a_hi @ b_lo) + big


def attention_3xtf32(q, k, v, n_valid, pb=None, gate=None, *, terms=3, v_slots=KEY_SLOTS,
                     store_dims=DIM_SLOTS):
    """The float32 body on head-major (B, H, T, 64) tensors, gate (B, H, T).

    Per batch element, 64-key tiles up to n_valid: S = Q·Kᵀ from split
    operands, scaled, biased and masked with the finite ``_NEG``; the online
    softmax in exp2; P in A's slot order (chunk kk's slot s is key 8kk +
    KEY_SLOTS[s]) times V's rows in ``v_slots`` order and V's columns in
    DIM_SLOTS order, summed from zero per tile, O = alpha·O + t; the output
    O·(1/l) written through ``store_dims``. Query tiles at or past n_valid
    are zeros."""
    b, h, t, d = q.shape
    out = torch.zeros_like(q)
    p_perm = torch.cat([8 * kk + KEY_SLOTS for kk in range(BK // 8)])
    v_perm = torch.cat([8 * kk + v_slots for kk in range(BK // 8)])
    for bi in range(b):
        n = min(max(int(n_valid[bi]), 1), t)
        rows = min(t, -(-n // BQ) * BQ)  # rows of the live query tiles
        qb = q[bi, :, :rows]
        m = torch.full((h, rows), fa._NEG)
        l = torch.zeros((h, rows))
        o = torch.zeros((h, rows, d))
        for k0 in range(0, n, BK):
            kt = torch.zeros((h, BK, d))  # keys past T zero-filled
            vt = torch.zeros((h, BK, d))
            kt[:, :min(BK, t - k0)] = k[bi, :, k0:k0 + BK]
            vt[:, :min(BK, t - k0)] = v[bi, :, k0:k0 + BK]
            x = _product(qb, kt.transpose(1, 2), terms) * 0.125
            keys = torch.arange(k0, k0 + BK)
            if pb is not None:
                pbt = torch.zeros((h, rows, BK))
                live = min(BK, n - k0)
                pbt[:, :, :live] = pb[:, :rows, k0:k0 + live]
                x = x + gate[bi, :, :rows, None] * pbt
            x = torch.where(keys < n, x, torch.tensor(fa._NEG))
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2((m - mn) * LOG2E)
            p = torch.exp2((x - mn[..., None]) * LOG2E)
            l = l * alpha + p.sum(-1)
            m = mn
            tile = _product(p[..., p_perm], vt[:, v_perm][..., DIM_SLOTS], terms)
            o = o * alpha[..., None] + tile
        res = o * (1.0 / l)[..., None]
        out[bi, :, :rows][..., store_dims] = res
    return out


def _inputs(b, t, h, seed):
    """q, k, v (B, H, T, 64) standard normal, pb (H, T, T) standard normal,
    gate (B, H, T) in [1, 3] (the card checks' draws)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, 64)).astype(np.float32) for _ in range(3))
    pb = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (b, h, t)).astype(np.float32)
    return q, k, v, pb, gate


CASES = [(63, [63, 1]), (130, [130, 65])]  # T, ragged n_valid (B=2)


def _max_err(got, want, nv):
    return max((got[i, :, :n] - want[i, :, :n]).abs().max().item() for i, n in enumerate(nv))


def test_fragment_orders_are_the_lanes():
    """KEY_SLOTS and DIM_SLOTS are what the kernel's lanes do: P's A slots
    from the accumulator, and one dim order for V's B fragment reads and for
    the output stores."""
    key_of_slot, v_dim, store_dim = _lane_fragment_orders()
    assert key_of_slot == KEY_SLOTS.tolist()
    assert v_dim == DIM_SLOTS.tolist() == store_dim
    assert sorted(v_dim) == list(range(64))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t,nv", CASES)
def test_3xtf32_emulation_matches_the_f32_twin(t, nv, bias):
    """The emulated body within TOL of the float32 twin on valid rows, and
    exact zeros in fully padded query tiles; one TF32 product per term is
    not within TOL (what the split buys)."""
    q, k, v, pb, gate = (torch.from_numpy(x) for x in _inputs(2, t, 2, seed=t + bias))
    extra = (pb, gate) if bias else (None, None)
    want = fa.flash_attention_reference(q, k, v, torch.tensor(nv), *extra)
    got = attention_3xtf32(q, k, v, nv, *extra)
    assert _max_err(got, want, nv) <= TOL
    for i, n in enumerate(nv):
        assert (got[i, :, -(-n // BQ) * BQ:] == 0).all()
    one = attention_3xtf32(q, k, v, nv, *extra, terms=1)
    assert _max_err(one, want, nv) > TOL


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("layout", ["packed", "headmajor"])
def test_3xtf32_emulation_matches_pallas_interpret(layout, bias):
    """Against the JAX package's kernels in interpret mode, from the same
    numpy inputs: ``flash_attention_packed`` (K1, K1b) on the packed
    (B, T, H*64) layout, ``flash_attention`` (K2) head-major."""
    import jax.numpy as jnp

    from fadtk_tpu.ops.flash_attention import flash_attention as jax_flash
    from fadtk_tpu.ops.flash_attention import flash_attention_packed as jax_packed

    t, nv = CASES[1]
    q, k, v, pb, gate = _inputs(2, t, 2, seed=7 + bias)
    jnv = jnp.asarray(nv, jnp.int32)
    jbias = (jnp.asarray(pb), jnp.asarray(gate)) if bias else (None, None)
    if layout == "packed":
        def packed(x):
            return x.transpose(0, 2, 1, 3).reshape(2, t, 128)

        pbj, gj = (jbias[0], jbias[1].transpose(0, 2, 1)) if bias else jbias
        want = jax_packed(*(jnp.asarray(packed(x)) for x in (q, k, v)), jnv, pbj, gj,
                          num_heads=2, interpret=True)
        want = np.asarray(want).reshape(2, t, 2, 64).transpose(0, 2, 1, 3)
    else:
        want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)), jnv, interpret=True,
                                    position_bias=jbias[0], gate=jbias[1]))
    tq, tk, tv, tpb, tgate = (torch.from_numpy(x) for x in (q, k, v, pb, gate))
    got = attention_3xtf32(tq, tk, tv, nv, *((tpb, tgate) if bias else (None, None)))
    assert _max_err(got, torch.from_numpy(np.array(want, np.float32)), nv) <= TOL


@pytest.mark.parametrize("wrong", ["V rows in natural key order", "stores in natural dim order"])
def test_a_wrong_renumbering_fails(wrong):
    """V's B fragment read at the natural key rows while P is in the
    renumbered slot order, or the outputs stored in natural dim order while
    V is read in DIM_SLOTS order: far outside TOL."""
    t, nv = CASES[1]
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(2, t, 2, seed=11))
    want = fa.flash_attention_reference(q, k, v, torch.tensor(nv))
    kw = ({"v_slots": torch.arange(8)} if wrong.startswith("V") else
          {"store_dims": torch.arange(64)})
    got = attention_3xtf32(q, k, v, nv, **kw)
    assert _max_err(got, want, nv) > 100 * TOL
