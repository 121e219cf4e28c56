"""The port's fused SEANet residual block (K4) against fadtk_tpu on the CPU.

The plain twin ``fused_resnet_causal_reference`` is held against the JAX
package's Pallas kernel (``fused_resnet_causal(interpret=True)``) and against
its XLA chain (``_resnet_block`` with the knob off), at the JAX test's cases
(tests/test_fused_resnet.py): T = 517, 130 and 3 at C=32, the multi-tile
C=256 T=4000, and bf16. The port's ``_resnet_block`` routes to the kernel
wrapper under exactly the JAX guard. The weight layouts the kernel reads
(float32 copies, or bf16 packed in the tensor cores' fragment order) are
built once per weight set and equal the per-call ones. The CUDA kernel is
held against the twin on the card (marked ``cuda``) in both dtypes at the
four call-site shapes of one 24 kHz forward and at ragged lengths.

JAX is imported inside the tests that use it: the machine with the card has
no JAX, and runs the ``cuda`` test there with
``python -m pytest --noconftest tests/test_torch_fused_resnet.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models import encodec_impl as enc
from fadtk_tpu_torch.ops import fused_resnet as fr

# The JAX test's bounds (assert_allclose atol = rtol): float32 differs by the
# order of the tap sums (measured <= 2.3e-5 at |out| ~ 48 for C=256); bf16
# rounds each product and bias sum to bf16 at points the two frameworks
# order differently (about one bf16 ulp of the output).
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _params(c, rng):
    """Weights ~ N(0, 0.3²) as tests/test_fused_resnet.py makes them:
    w1 (C/2, C, 3), b1, w2 (C, C/2), b2, wsc (C, C), bsc."""
    ch = c // 2
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((ch, c, 3), (ch,), (c, ch), (c,), (c, c), (c,))]


def _inputs(b, c, t, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, t)) * 0.5).astype(np.float32)
    return x, _params(c, rng)


def _twin(x, ps, dtype):
    tdt = getattr(torch, dtype)
    out = fr.fused_resnet_causal_reference(*(torch.from_numpy(a).to(tdt) for a in [x, *ps]))
    assert out.dtype == tdt and out.shape == x.shape
    return out.float().numpy()


def _jax_block_params(ps, dtype):
    import jax.numpy as jnp

    w1, b1, w2, b2, wsc, bsc = (jnp.asarray(a, dtype) for a in ps)
    return {"block_conv1": {"kernel": w1, "bias": b1},
            "block_conv2": {"kernel": w2[:, :, None], "bias": b2},
            "shortcut": {"kernel": wsc[:, :, None], "bias": bsc}}


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("b,c,t,dtype", [
    (2, 32, 517, "float32"), (2, 32, 130, "float32"), (2, 32, 3, "float32"),
    (1, 256, 4000, "float32"),  # several Pallas tiles with a ragged tail
    (2, 32, 260, "bfloat16"),
])
def test_twin_matches_pallas_interpret(b, c, t, dtype):
    import jax.numpy as jnp

    from fadtk_tpu.ops.fused_resnet import fused_resnet_causal as jax_kernel

    x, ps = _inputs(b, c, t, seed=t)
    want = jax_kernel(*(jnp.asarray(a, dtype) for a in [x, *ps]), interpret=True)
    _close(_twin(x, ps, dtype), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("b,c,t,dtype", [
    (2, 32, 517, "float32"), (2, 32, 3, "float32"), (1, 256, 4000, "float32"),
    (2, 32, 260, "bfloat16"),
])
def test_twin_matches_jax_resnet_block(b, c, t, dtype, monkeypatch):
    """Against the JAX package's plain chain (``_resnet_block``, knob off)."""
    import jax.numpy as jnp

    from fadtk_tpu.models.encodec_impl import CONFIG_24K, _resnet_block

    monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", "0")
    x, ps = _inputs(b, c, t, seed=t + 1)
    want = _resnet_block(CONFIG_24K, _jax_block_params(ps, dtype), jnp.asarray(x, dtype), (1, 1))
    _close(_twin(x, ps, dtype), np.asarray(want, np.float32), dtype)


# --------------------------------------------------------------------------- #
# Routing
# --------------------------------------------------------------------------- #


def _block(cfg, c, seed):
    rng = np.random.default_rng(seed)
    w1, b1, w2, b2, wsc, bsc = (torch.from_numpy(a) for a in _params(c, rng))
    p = enc.ResnetBlock(c, c // 2, 3, True, cfg.norm_type == "time_group_norm")
    with torch.no_grad():
        for conv, w, bias in ((p.block_conv1, w1, b1), (p.block_conv2, w2[:, :, None], b2),
                              (p.shortcut, wsc[:, :, None], bsc)):
            conv.weight.copy_(w)
            conv.bias.copy_(bias)
    return p


def _spy(monkeypatch):
    calls = []

    def spy(x, *weights):
        calls.append(tuple(x.shape))
        return fr.fused_resnet_causal_reference(x, *weights)

    monkeypatch.setattr(fr, "fused_resnet_causal", spy)
    return calls


@pytest.mark.parametrize("env,kernel", [("1", True), ("true", True), ("0", False), ("", False)])
def test_resnet_block_routes_under_the_knob(env, kernel, monkeypatch):
    """24k blocks take the wrapper only with FADTK_TPU_FUSED_RESNET truthy,
    and the two routes agree."""
    monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", env)
    assert fr.fused_resnet_enabled() is kernel
    calls = _spy(monkeypatch)
    p = _block(enc.CONFIG_24K, 32, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 32, 300)).astype(np.float32))
    with torch.no_grad():
        got = enc._resnet_block(enc.CONFIG_24K, p, x, (1, 1))
        monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", "0")
        chain = enc._resnet_block(enc.CONFIG_24K, p, x, (1, 1))
    assert calls == ([(2, 32, 300)] if kernel else [])
    _close(got.numpy(), chain.numpy(), "float32")


def test_knob_default_off(monkeypatch):
    monkeypatch.delenv("FADTK_TPU_FUSED_RESNET", raising=False)
    assert not fr.fused_resnet_enabled()


@pytest.mark.parametrize("case", ["48k", "dilation", "short", "no_shortcut"])
def test_guard_refuses(case, monkeypatch):
    """The JAX guard: not the 48k config (non-causal, time group norm), not a
    dilated first conv, not T < 3, not without a conv shortcut."""
    from dataclasses import replace

    monkeypatch.setenv("FADTK_TPU_FUSED_RESNET", "1")
    calls = _spy(monkeypatch)
    cfg, dil, t = enc.CONFIG_24K, (1, 1), 64
    if case == "48k":
        cfg = enc.CONFIG_48K
    elif case == "dilation":
        dil = (2, 1)
    elif case == "short":
        t = 2
    else:
        cfg = replace(cfg, use_conv_shortcut=False)
    p = _block(cfg, 32, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 32, t)).astype(np.float32))
    with torch.no_grad():
        out = enc._resnet_block(cfg, p, x, dil)
    assert calls == [] and out.shape == x.shape and torch.isfinite(out).all()


def test_cpu_wrapper_runs_the_twin_without_a_launch():
    x, ps = _inputs(2, 64, 97, seed=4)
    args = [torch.from_numpy(a) for a in [x, *ps]]
    before = (fr.fused_resnet_causal.launches, fr.fused_resnet_causal.bf16_launches)
    got = fr.fused_resnet_causal(*args)
    assert torch.equal(got, fr.fused_resnet_causal_reference(*args))
    assert (fr.fused_resnet_causal.launches, fr.fused_resnet_causal.bf16_launches) == before


# --------------------------------------------------------------------------- #
# The kernel's weight layouts, prepared once per weight set
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [32, 256])
def test_cached_weight_layout_equals_the_per_call_one(c, dtype):
    """kernel_weights builds a weight set's layout once, and it equals the
    layout built afresh (what the wrapper did on every call before); another
    weight tensor, or one written in place, builds again."""
    tdt = getattr(torch, dtype)
    _, ps = _inputs(1, c, 3, seed=c)
    w = [torch.from_numpy(a).to(tdt) for a in ps]
    before = fr.kernel_weights.builds
    first = fr.kernel_weights(*w)
    assert fr.kernel_weights(*w) is first and fr.kernel_weights.builds == before + 1
    fresh = fr._build_weights(*w)
    assert len(first) == len(fresh) == 6
    for a, b in zip(first, fresh):
        assert a.dtype == b.dtype and a.is_contiguous() and torch.equal(a, b)
    assert [t.dtype for t in first[1::2]] == [torch.float32] * 3
    # bf16: the m16n8k16 fragment order; float32: TF32 hi and lo parts in
    # the m16n8k8 order; w1's K is (tap, channel)
    pack = fr.pack_fragments if dtype == "bfloat16" else fr.pack_tf32_fragments
    w1r = w[0].permute(0, 2, 1).reshape(c // 2, 3 * c)
    assert [torch.equal(a, pack(b)) for a, b in zip(first[::2], (w1r, w[2], w[4]))] == [True] * 3
    w[2].mul_(1)
    assert fr.kernel_weights(*w) is not first and fr.kernel_weights.builds == before + 2
    # the model passes fresh views (weight[:, :, 0]) of the same parameters
    again = fr.kernel_weights(*w)
    w2, wsc = w[2][:, :, None], w[4][:, :, None]
    assert fr.kernel_weights(w[0], w[1], w2[:, :, 0], w[3], wsc[:, :, 0], w[5]) is again
    assert fr.kernel_weights.builds == before + 2
    with torch.inference_mode():  # weights made there keep no version counter
        inf = [t.clone() for t in w]
    assert fr.kernel_weights(*inf) is fr.kernel_weights(*inf)


def test_pack_fragments_is_the_mma_b_operand_order():
    """Lane l of n8 tile i and k16 tile j holds rows 8i + l//4 and columns
    16j + 2(l%4) + (0, 1, 8, 9); every weight appears once."""
    n, k = 16, 48
    w = torch.arange(n * k, dtype=torch.float32).reshape(n, k)
    p = fr.pack_fragments(w)
    assert p.shape == (n // 8, k // 16, 32, 4)
    for i in range(n // 8):
        for j in range(k // 16):
            for lane in range(32):
                row, col = 8 * i + lane // 4, 16 * j + 2 * (lane % 4)
                assert p[i, j, lane].tolist() == [w[row, col + d].item() for d in (0, 1, 8, 9)]
    assert torch.equal(p.flatten().sort().values, w.flatten())


# --------------------------------------------------------------------------- #
# The kernel on the card
# --------------------------------------------------------------------------- #

# The four call sites of one encodec-emb forward of 10 s clips (24 kHz):
# (C, T) after each downsampling stage.
PATH_SHAPES = [(32, 240000), (64, 120000), (128, 30000), (256, 6000)]


def _path_inputs(b, c, t, seed):
    """x ~ N(0, 0.5²) and the model's weight scale, U(±1/√fan_in), biases
    U(±0.1), as chip_smoke.py makes them: intermediates stay below ~4, where
    a bf16 ulp is ≤ 1.6e-2. (With the CPU cases' N(0, 0.3²) weights, C=256
    sums reach |16|: one ulp there, 6.25e-2, where the output cancels to
    ~0.05, fails the bound on a few of 6.1M values.)"""
    rng = np.random.default_rng(seed)
    ch = c // 2

    def u(shape, s):
        return rng.uniform(-s, s, shape).astype(np.float32)

    x = (rng.standard_normal((b, c, t)) * 0.5).astype(np.float32)
    return x, [u((ch, c, 3), (3 * c) ** -0.5), u((ch,), 0.1), u((c, ch), ch ** -0.5),
               u((c,), 0.1), u((c, c), c ** -0.5), u((c,), 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,t", PATH_SHAPES)
def test_kernel_matches_twin_on_card(c, t, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False  # the f32 twin's convs must be f32
    b = 4
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    x, ps = _path_inputs(b, c, t, seed=c)
    args = [torch.from_numpy(a).to(dev, tdt) for a in [x, *ps]]
    counter = "bf16_launches" if dtype == "bfloat16" else "launches"
    before = getattr(fr.fused_resnet_causal, counter)
    got = fr.fused_resnet_causal(*args)
    want = fr.fused_resnet_causal_reference(*args)
    torch.cuda.synchronize()
    assert getattr(fr.fused_resnet_causal, counter) == before + 1
    assert got.dtype == tdt and torch.isfinite(got.float()).all()
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), dtype)
    with pytest.raises(ValueError, match="the kernel takes C in"):
        fr.fused_resnet_causal(args[0][:, :24].contiguous(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,t", [(3, 64, 1001), (2, 32, 3), (2, 256, 70), (1, 128, 129)])
def test_kernel_matches_twin_on_ragged_lengths(b, c, t, dtype):
    """Lengths that are not a multiple of the tile, nor of 8 (the bf16 form's
    16-byte rows), and the minimum T = 3 (the reflected halo only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    tdt = getattr(torch, dtype)
    x, ps = _path_inputs(b, c, t, seed=t)
    args = [torch.from_numpy(a).to("cuda", tdt) for a in [x, *ps]]
    got = fr.fused_resnet_causal(*args)
    want = fr.fused_resnet_causal_reference(*args)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), dtype)
