"""The float32 form of the port's fused SEANet block (K4) as 3xTF32, on the CPU.

The card kernel takes each product three times on TF32 operands split into
hi and lo parts (``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi``, float32
accumulation). What the CPU can hold of that: the split and the packing the
wrapper gives the kernel (the weights in ``mma.m16n8k8`` tf32 B-fragment
order), and a plain-torch emulation of the 3xTF32 block, with the kernel's
split operands and rounding points, against the float32 twin within the
card's bound (``K4_TOL["float32"]`` in chip_smoke.py) at every width of the
24 kHz encoder. The kernel itself is held against the twin on the card by
``tests/test_torch_fused_resnet.py``'s ``cuda`` tests.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fadtk_tpu_torch.ops import fused_resnet as fr

TOL = 2e-5  # atol = rtol, the float32 bound of the card checks


def _weights(c, seed):
    """The model's random-init scale, as the card checks draw them:
    U(±1/√fan_in) weights, U(±0.1) biases; x ~ N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    ch = c // 2

    def u(shape, s):
        return torch.from_numpy(rng.uniform(-s, s, shape).astype(np.float32))

    x = torch.from_numpy((rng.standard_normal((2, c, 67)) * 0.5).astype(np.float32))
    return x, [u((ch, c, 3), (3 * c) ** -0.5), u((ch,), 0.1), u((c, ch), ch ** -0.5),
               u((c,), 0.1), u((c, c), c ** -0.5), u((c,), 0.1)]


def _low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_split_reproduces_each_weight():
    """hi and lo are TF32 values (the low 13 of float32's 23 mantissa bits
    zero), hi is x rounded to nearest at 10 bits, and hi + lo is x within
    2^-21 relative, over six decades of magnitude and both signs."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-4, 2, 4096))
                         .astype(np.float32))
    hi, lo = fr.split_tf32(w)
    assert (_low_bits(hi) == 0).all() and (_low_bits(lo) == 0).all()
    w64, hi64, lo64 = (t.double() for t in (w, hi, lo))
    assert ((w64 - hi64).abs() <= 2.0 ** -11 * w64.abs()).all()
    assert ((hi64 + lo64 - w64).abs() <= 2.0 ** -21 * w64.abs()).all()
    # ties go away from zero, as cvt.rna rounds
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert fr.tf32_round(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def test_pack_tf32_fragments_is_the_mma_b_operand_order():
    """Lane l of n8 tile i and k8 tile j holds hi and lo of row 8i + l//4,
    columns 8j + l%4 and 8j + l%4 + 4, as (hi, hi, lo, lo); every split
    value appears once."""
    n, k = 16, 24
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((n, k)).astype(np.float32))
    hi, lo = fr.split_tf32(w)
    p = fr.pack_tf32_fragments(w)
    assert p.shape == (n // 8, k // 8, 32, 4) and p.dtype == torch.float32
    for i in range(n // 8):
        for j in range(k // 8):
            for lane in range(32):
                row, col = 8 * i + lane // 4, 8 * j + lane % 4
                assert p[i, j, lane].tolist() == [hi[row, col].item(), hi[row, col + 4].item(),
                                                  lo[row, col].item(), lo[row, col + 4].item()]
    assert torch.equal(p[..., :2].flatten().sort().values, hi.flatten().sort().values)
    assert torch.equal(p[..., 2:].flatten().sort().values, lo.flatten().sort().values)


def _product(a, w, terms):
    """(N, K) weights times a (B, K, T) channel-major operand, from split
    operands: ``terms`` 3 is the kernel's a_lo·w_hi + a_hi·w_lo, then
    + a_hi·w_hi; 1 is one TF32 product."""
    a_hi, a_lo = fr.split_tf32(a)
    w_hi, w_lo = fr.split_tf32(w)
    big = torch.einsum("nk,bkt->bnt", w_hi, a_hi)
    if terms == 1:
        return big
    return (torch.einsum("nk,bkt->bnt", w_hi, a_lo) + torch.einsum("nk,bkt->bnt", w_lo, a_hi)) + big


def _block_tf32(x, w1, b1, w2, b2, wsc, bsc, terms=3):
    """The kernel's formulation: e = elu(x) reflected by two columns; the
    k=3 conv as one product over K = (tap, channel) of three shifted views;
    h = elu(conv + b1); out = (wsc·x + w2·h) + bsc + b2."""
    ch, c, _ = w1.shape
    t = x.shape[-1]
    e = F.pad(F.elu(x), (2, 0), mode="reflect")
    taps = torch.cat([e[:, :, tap:tap + t] for tap in range(3)], dim=1)  # (B, 3C, T)
    w1r = w1.permute(0, 2, 1).reshape(ch, 3 * c)
    h = F.elu(_product(taps, w1r, terms) + b1[:, None])
    acc = _product(x, wsc, terms) + _product(h, w2, terms)
    return acc + bsc[:, None] + b2[:, None]


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_3xtf32_emulation_matches_the_f32_twin(c):
    """The 3xTF32 block within K4_TOL["float32"] (atol = rtol) of the float32
    twin at each width; one TF32 product per term is not (what the split
    buys)."""
    x, w = _weights(c, seed=c)
    want = fr.fused_resnet_causal_reference(x, *w)
    got = _block_tf32(x, *w)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    one = _block_tf32(x, *w, terms=1)
    assert ((one - want).abs() > TOL + TOL * want.abs()).any()
