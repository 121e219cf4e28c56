"""The port's fused log-mel kernel (K3) against fadtk_tpu on the CPU.

The plain twin ``fused_log_mel_reference`` is held against the JAX package's
Pallas kernel (``fused_log_mel(interpret=True)``) in all three log modes at
tests/test_pallas_mel.py's two shapes, and on a strided ``unfold`` view of a
signal against the same frames made contiguous. The CUDA kernel is held
against the twin on the card (marked ``cuda``): at Whisper's geometry through
the strided view, at VGGish's and CLAP's bases on contiguous frames, and at
small ragged shapes, through the folded and the unfolded template. On the
CPU, the kernel's layout (the even/odd fold decision, the padded bases, the
mel bands, built once per base tensor) and its folded formulation in plain
torch are held against the twin.

JAX is imported inside the tests that use it: the machine with the card has
no JAX, and runs the ``cuda`` tests there with
``python -m pytest --noconftest tests/test_torch_fused_log_mel.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.dsp import mel as dmel
from fadtk_tpu_torch.ops import fused_log_mel as k3

# The JAX test's bound (tests/test_pallas_mel.py): float32 products summed in
# another order; measured <= 2e-6 on these inputs.
ATOL = 2e-4
MODES = [("ln_offset", 0.01), ("log10_clamp", 0.0), ("db_clamp", 0.0)]


def _inputs(n, w, f, m, seed):
    """tests/test_pallas_mel.py's inputs: frames N(0, 0.3²), bases
    N(0, 0.05²), a non-negative mel matrix."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((n, w)).astype(np.float32) * 0.3
    dre = rng.standard_normal((w, f)).astype(np.float32) * 0.05
    dim = rng.standard_normal((w, f)).astype(np.float32) * 0.05
    mel = np.abs(rng.standard_normal((f, m))).astype(np.float32) * 0.01
    return frames, dre, dim, mel


@pytest.mark.parametrize("log_mode,log_offset", MODES)
@pytest.mark.parametrize("n,w,f,m", [(100, 400, 257, 64), (300, 1024, 513, 80)])
def test_twin_matches_pallas_interpret(log_mode, log_offset, n, w, f, m):
    import jax.numpy as jnp

    from fadtk_tpu.dsp.pallas_mel import fused_log_mel as jax_kernel

    arrays = _inputs(n, w, f, m, seed=n + w)
    want = np.asarray(jax_kernel(*(jnp.asarray(a) for a in arrays), log_mode=log_mode,
                                 log_offset=log_offset, interpret=True))
    got = k3.fused_log_mel_reference(*(torch.from_numpy(a) for a in arrays),
                                     log_mode=log_mode, log_offset=log_offset)
    assert got.dtype == torch.float32 and got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("log_mode,log_offset", MODES)
def test_twin_on_a_strided_view_equals_contiguous_frames(log_mode, log_offset):
    """Whisper's frames as the kernel takes them (an ``unfold`` view of the
    padded signal, frame stride = hop) and made contiguous give the same
    values; the wrapper on CPU tensors takes the same route."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.2).astype(np.float32))
    view = dmel.whisper_frames(torch.nn.functional.pad(x, (0, 480000 - 16000)))[:, :120]
    assert view.stride() == (480400, 160, 1)
    bases = dmel._device_bases("whisper", torch.device("cpu"))
    strided = k3.fused_log_mel(view, *bases, log_mode=log_mode, log_offset=log_offset)
    dense = k3.fused_log_mel_reference(view.contiguous(), *bases, log_mode=log_mode,
                                       log_offset=log_offset)
    assert strided.shape == (2, 120, 80)
    torch.testing.assert_close(strided, dense, rtol=0, atol=0)


def test_cpu_wrapper_runs_the_twin_without_a_launch():
    arrays = [torch.from_numpy(a) for a in _inputs(37, 400, 201, 80, seed=3)]
    before = k3.fused_log_mel.launches
    got = k3.fused_log_mel(*arrays, log_mode="log10_clamp")
    assert torch.equal(got, k3.fused_log_mel_reference(*arrays, log_mode="log10_clamp"))
    assert k3.fused_log_mel.launches == before


def test_unknown_log_mode_raises():
    arrays = [torch.from_numpy(a) for a in _inputs(4, 400, 201, 80, seed=4)]
    with pytest.raises(ValueError, match="log_mode"):
        k3.fused_log_mel(*arrays, log_mode="log2")


# --------------------------------------------------------------------------- #
# The kernel's layout: the even/odd fold, the padded bases, the mel bands
# --------------------------------------------------------------------------- #


def _family_bases(case):
    cpu = torch.device("cpu")
    if case == "clap":
        return dmel._device_bases("torchlibrosa", cpu, 1024, 48000, 64, 50.0, 14000.0)
    return dmel._device_bases(case, cpu)


@pytest.mark.parametrize("case,folds", [("whisper", True), ("clap", True), ("vggish", False),
                                        ("ramp", False)])
def test_fold_decision(case, folds):
    """Periodic Hann with W = n_fft folds (Whisper W=400, CLAP W=1024); VGGish's
    400-sample window in a 512-point DFT does not, nor Whisper's DFT under a
    window that is not symmetric (a ramp)."""
    if case == "ramp":
        w, n_fft = 400, 400
        phase = -2.0 * np.pi * np.outer(np.arange(w), np.arange(n_fft // 2 + 1)) / n_fft
        ramp = np.linspace(0.0, 1.0, w)[:, None]
        bases = [torch.from_numpy((f(phase) * ramp).astype(np.float32)) for f in (np.cos, np.sin)]
    else:
        bases = _family_bases(case)[:2]
    assert k3.bases_fold(*bases) is folds


# The folded product sums other float32 terms in another order than the
# twin's (W, F) GEMM: measured <= 2.2e-6 on log10 and ln values; the dB
# mode is ten times the log10 value.
FOLDED_ATOL = {"ln_offset": 1e-5, "log10_clamp": 1e-5, "db_clamp": 1e-4}


@pytest.mark.parametrize("log_mode,log_offset", MODES)
@pytest.mark.parametrize("case", ["whisper", "clap", "vggish"])
def test_folded_formulation_matches_twin(case, log_mode, log_offset):
    """The kernel's formulation in plain torch over the cached layout (folded
    for Whisper and CLAP, all W rows for VGGish) against the twin."""
    bases = _family_bases(case)
    layout = k3.kernel_layout(*bases)
    w, f = bases[0].shape
    assert layout.k == (w // 2 + 1 if layout.fold else w)
    kp, fp = layout.bases.shape[1:]
    assert kp % 16 == 0 and kp >= layout.k and fp % 128 == 0 and fp >= f
    rng = np.random.default_rng(w)
    frames = torch.from_numpy((rng.standard_normal((3, 41, w)) * 0.1).astype(np.float32))
    got = k3.fused_log_mel_folded_reference(frames, layout, bases[2], log_mode=log_mode,
                                            log_offset=log_offset)
    want = k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    torch.testing.assert_close(got, want, rtol=0, atol=FOLDED_ATOL[log_mode])


def test_layout_is_built_once_per_base_tensor():
    """One build per base tensor; another tensor with the same values, or the
    same tensor written in place, builds again. The bands hold every nonzero
    of the mel matrix."""
    dre, dim, mel = (t.clone() for t in _family_bases("whisper"))
    before = k3.kernel_layout.builds
    first = k3.kernel_layout(dre, dim, mel)
    assert k3.kernel_layout(dre, dim, mel) is first
    assert k3.kernel_layout.builds == before + 1
    other = k3.kernel_layout(dre.clone(), dim, mel)
    assert other is not first and k3.kernel_layout.builds == before + 2
    mel.mul_(1.0)
    assert k3.kernel_layout(dre, dim, mel) is not first
    assert k3.kernel_layout.builds == before + 3
    with torch.inference_mode():  # bases made there keep no version counter
        inf = [t.clone() for t in (dre, dim, mel)]
    assert k3.kernel_layout(*inf) is k3.kernel_layout(*inf)
    lo, hi = first.band.long()
    rows = torch.arange(mel.shape[0])[:, None]
    inside = (rows >= lo[None]) & (rows < hi[None])
    assert not (mel != 0)[~inside].any()


# --------------------------------------------------------------------------- #
# The kernel on the card
# --------------------------------------------------------------------------- #

# kernel vs twin on log values: float32 FMA chains against cuBLAS's float32
# GEMMs (TF32 off) sum in other orders; log10 of a relative error e of the
# mel value moves by e/ln(10), db by 10x that.
CARD_ATOL = {"ln_offset": 1e-4, "log10_clamp": 1e-4, "db_clamp": 1e-3}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_check(frames, bases, log_mode, log_offset=0.0):
    before = k3.fused_log_mel.launches
    got = k3.fused_log_mel(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    want = k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    torch.cuda.synchronize()
    assert k3.fused_log_mel.launches == before + 1
    assert got.shape == want.shape and got.is_contiguous() and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=CARD_ATOL[log_mode])


@pytest.mark.cuda
@pytest.mark.parametrize("log_mode,log_offset", MODES)
def test_kernel_matches_twin_at_whispers_geometry(log_mode, log_offset):
    """B=4 30 s windows through the strided view of the padded signal."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn((4, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1
    _card_check(dmel.whisper_frames(audio), dmel._device_bases("whisper", dev), log_mode,
                log_offset)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vggish", "clap"])
def test_kernel_matches_twin_on_contiguous_frames(case):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    if case == "vggish":
        frames = torch.randn((4096, 400), generator=g, device=dev) * 0.1
        _card_check(frames, dmel._device_bases("vggish", dev), "ln_offset", 0.01)
    else:
        frames = torch.randn((2002, 1024), generator=g, device=dev) * 0.1
        bases = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
        _card_check(frames, bases, "db_clamp")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whisper", "vggish"])
@pytest.mark.parametrize("n", [1, 63, 65, 130])
def test_kernel_matches_twin_on_ragged_tiles(n, case):
    """Ragged frame tiles through the folded (Whisper's bases) and the
    unfolded (VGGish's) templates."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    frames = torch.randn((3, n, 400), generator=g, device=dev) * 0.1
    bases = dmel._device_bases(case, dev)
    assert k3.kernel_layout(*bases).fold is (case == "whisper")
    _card_check(frames, bases, "log10_clamp")
    with pytest.raises(ValueError, match="unit sample stride"):
        k3.fused_log_mel(frames[:, :, ::2], *bases, log_mode="log10_clamp")
