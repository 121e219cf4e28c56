"""The port's fused log-mel kernel (K3) against fadtk_tpu on the CPU.

The plain twin ``fused_log_mel_reference`` is held against the JAX package's
Pallas kernel (``fused_log_mel(interpret=True)``) in all three log modes at
tests/test_pallas_mel.py's two shapes, and on a strided ``unfold`` view of a
signal against the same frames made contiguous. The CUDA kernel is held
against the twin on the card (marked ``cuda``): at Whisper's geometry through
the strided view (the folded body), at CLAP's two frontends through the
strided view and VGGish's bases on contiguous frames (the FFT body), at
random bases (the unfolded body), and at small ragged shapes through every
body. On the CPU, the kernel's layouts (which body serves which bases: the
FFT recogniser and the even/odd fold; the padded bases, the window, the
twiddles, the mel bands, built once per base tensor) and the bodies'
formulations in plain torch (folded, and the FFT's radix steps and split)
are held against the twin, and the FFT formulation against the JAX
package's Pallas kernel.

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
    """On CPU tensors the wrapper runs the twin whatever body the bases would
    take on the card (random bases; CLAP's, an FFT layout): no count moves."""
    arrays = [torch.from_numpy(a) for a in _inputs(37, 400, 201, 80, seed=3)]
    before = k3.fused_log_mel.launches, k3.fused_log_mel.fft_launches
    got = k3.fused_log_mel(*arrays, log_mode="log10_clamp")
    assert torch.equal(got, k3.fused_log_mel_reference(*arrays, log_mode="log10_clamp"))
    frames = torch.from_numpy(_inputs(5, 1024, 513, 64, seed=3)[0])
    bases = _family_bases("clap")
    got = k3.fused_log_mel(frames, *bases, log_mode="db_clamp")
    assert torch.equal(got, k3.fused_log_mel_reference(frames, *bases, log_mode="db_clamp"))
    assert (k3.fused_log_mel.launches, k3.fused_log_mel.fft_launches) == before


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
    """The FMA bodies' formulation in plain torch over their layout (folded
    for Whisper and CLAP, all W rows for VGGish; CLAP's and VGGish's bases
    reach the FFT body in the kernel, and the FMA layout of any bases stays
    defined) against the twin."""
    bases = _family_bases(case)
    layout = k3._fma_layout(*bases)
    w, f = bases[0].shape
    assert layout.body == ("unfolded" if case == "vggish" else "folded")
    assert layout.k == (w // 2 + 1 if layout.fold else w)
    kp, fp = layout.bases.shape[1:]
    assert kp % 16 == 0 and kp >= layout.k and fp % 128 == 0 and fp >= f
    rng = np.random.default_rng(w)
    frames = torch.from_numpy((rng.standard_normal((3, 41, w)) * 0.1).astype(np.float32))
    got = k3.fused_log_mel_folded_reference(frames, layout, bases[2], log_mode=log_mode,
                                            log_offset=log_offset)
    want = k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    torch.testing.assert_close(got, want, rtol=0, atol=FOLDED_ATOL[log_mode])


def _clap_bases(sr):
    return dmel._device_bases("torchlibrosa", torch.device("cpu"), 1024, sr, 64, 50.0, 14000.0)


def _random_bases(w, f, m, seed):
    """Bases that are no DFT: tests/test_pallas_mel.py's random ones."""
    return tuple(torch.from_numpy(a) for a in _inputs(1, w, f, m, seed)[1:])


@pytest.mark.parametrize("case,want", [("clap48", True), ("clap44", True), ("vggish", True),
                                       ("whisper", False), ("random", False),
                                       ("clap_perturbed", False)])
def test_fft_decision(case, want):
    """CLAP's bases (n_fft 1024 at both sample rates) and VGGish's (a
    400-sample window in a 512-point DFT) are a windowed power-of-two DFT;
    Whisper's (n_fft 400), random bases and CLAP's with one entry moved by
    1e-3 (hundreds of ulps of the largest value) are not. The layout takes
    the FFT body exactly where the recogniser says yes; the rest keep their
    FMA body."""
    if case.startswith("clap"):
        bases = [t.clone() for t in _clap_bases(44100 if case == "clap44" else 48000)]
        if case == "clap_perturbed":
            bases[1][517, 100] += 1e-3
    elif case == "random":
        bases = _random_bases(1024, 513, 64, seed=11)
    else:
        bases = _family_bases(case)
    assert k3.bases_fft(*bases[:2]) is want
    layout = k3._build_layout(*bases)
    assert layout.body == ("fft" if want else "folded" if k3.bases_fold(*bases[:2])
                           else "unfolded")


# The FFT formulation sums other float32 terms in another order than the
# twin's (W, F) GEMM (radix-8 butterflies of n_fft / 2 points, then the
# split): measured <= 1.5e-6 on log10 and ln values, 7.6e-6 in dB (ten
# times the log10 value), the folded formulation's bounds hold.
FFT_ATOL = FOLDED_ATOL


@pytest.mark.parametrize("log_mode,log_offset", MODES)
@pytest.mark.parametrize("case", ["clap48", "clap44", "vggish"])
def test_fft_formulation_matches_twin(case, log_mode, log_offset):
    """The FFT body's formulation in plain torch (windowed frame packed as
    n_fft / 2 complex points, the Stockham radix steps with the layout's
    twiddles, the split, the power over the band union) against the twin,
    on three clips of ragged frame counts."""
    bases = _clap_bases(44100 if case == "clap44" else 48000) if case != "vggish" else \
        _family_bases("vggish")
    layout = k3.kernel_layout(*bases)
    w, f = bases[0].shape
    n_fft = 2 * (f - 1)
    assert layout.body == "fft" and layout.window.shape == (n_fft,)
    assert torch.equal(layout.window[:w], bases[0][:, 0]) and not layout.window[w:].any()
    assert layout.twiddle.shape == (n_fft, 2) and layout.twiddle.dtype == torch.float32
    lo, hi = layout.bins
    assert 0 <= lo < hi <= f and not (bases[2] != 0)[:lo].any() and not (bases[2] != 0)[hi:].any()
    band = layout.band.long()
    assert layout.mel_packed.numel() == int((band[1] - band[0]).sum())
    assert int(layout.packed_at[-1]) + int(band[1, -1] - band[0, -1]) == layout.mel_packed.numel()
    rng = np.random.default_rng(f)
    frames = torch.from_numpy((rng.standard_normal((3, 37, w)) * 0.1).astype(np.float32))
    got = k3.fused_log_mel_fft_reference(frames, layout, log_mode=log_mode,
                                         log_offset=log_offset)
    want = k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    assert got.shape == want.shape == (3, 37, bases[2].shape[1])
    torch.testing.assert_close(got, want, rtol=0, atol=FFT_ATOL[log_mode])


def test_fft_formulation_matches_pallas_interpret():
    """The FFT formulation at CLAP's geometry (48 kHz bases, dB) against the
    JAX package's Pallas kernel in interpret mode on the same frames, within
    the JAX test's bound (ATOL; measured within 2e-5 dB)."""
    import jax.numpy as jnp

    from fadtk_tpu.dsp.pallas_mel import fused_log_mel as jax_kernel

    bases = _clap_bases(48000)
    rng = np.random.default_rng(21)
    frames = (rng.standard_normal((64, 1024)) * 0.1).astype(np.float32)
    want = np.asarray(jax_kernel(jnp.asarray(frames), *(jnp.asarray(b.numpy()) for b in bases),
                                 log_mode="db_clamp", interpret=True))
    got = k3.fused_log_mel_fft_reference(torch.from_numpy(frames), k3.kernel_layout(*bases),
                                         log_mode="db_clamp")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fft_radices():
    assert k3.fft_radices(512) == [8, 8, 8] and k3.fft_radices(256) == [8, 8, 4]


def _builds_once(dre, dim, mel):
    """One build per base tensor; another tensor with the same values, or the
    same tensor written in place, builds again. Returns the first layout."""
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
    return first


def test_layout_is_built_once_per_base_tensor():
    """The FMA layout (Whisper's bases) is built once per base tensor; the
    bands hold every nonzero of the mel matrix."""
    dre, dim, mel = (t.clone() for t in _family_bases("whisper"))
    first = _builds_once(dre, dim, mel)
    assert first.body == "folded"
    lo, hi = first.band.long()
    rows = torch.arange(mel.shape[0])[:, None]
    inside = (rows >= lo[None]) & (rows < hi[None])
    assert not (mel != 0)[~inside].any()


def test_fft_layout_is_built_once_per_base_tensor():
    """The FFT layout (CLAP's bases: window, twiddles, band union) is built
    once per base tensor too; its twiddles are exp(-2 pi i j / n_fft) to
    float32 rounding of float64 values."""
    dre, dim, mel = (t.clone() for t in _family_bases("clap"))
    first = _builds_once(dre, dim, mel)
    assert first.body == "fft" and first.k is None and first.bases is None
    j = torch.arange(1024, dtype=torch.float64)
    want = torch.polar(torch.ones_like(j), -2 * np.pi * j / 1024)
    got = torch.complex(first.twiddle[:, 0].double(), first.twiddle[:, 1].double())
    assert (got - want).abs().max() <= 2 ** -24


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
    body = k3.kernel_layout(*bases).body
    counter = "fft_launches" if body == "fft" else "launches"
    before = getattr(k3.fused_log_mel, counter)
    got = k3.fused_log_mel(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    want = k3.fused_log_mel_reference(frames, *bases, log_mode=log_mode, log_offset=log_offset)
    torch.cuda.synchronize()
    assert getattr(k3.fused_log_mel, counter) == before + 1
    assert got.shape == want.shape and got.is_contiguous() and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=CARD_ATOL[log_mode])
    return body


@pytest.mark.cuda
@pytest.mark.parametrize("log_mode,log_offset", MODES)
def test_kernel_matches_twin_at_whispers_geometry(log_mode, log_offset):
    """B=4 30 s windows through the strided view of the padded signal."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    audio = torch.randn((4, dmel.WHISPER_SAMPLES), generator=g, device=dev) * 0.1
    assert _card_check(dmel.whisper_frames(audio), dmel._device_bases("whisper", dev), log_mode,
                       log_offset) == "folded"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["vggish", "clap"])
def test_kernel_matches_twin_on_contiguous_frames(case):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    if case == "vggish":
        frames = torch.randn((4096, 400), generator=g, device=dev) * 0.1
        body = _card_check(frames, dmel._device_bases("vggish", dev), "ln_offset", 0.01)
    else:
        frames = torch.randn((2002, 1024), generator=g, device=dev) * 0.1
        bases = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
        body = _card_check(frames, bases, "db_clamp")
    assert body == "fft"


@pytest.mark.cuda
@pytest.mark.parametrize("sr,seconds,hop", [(48000, 10, 480), (44100, 7, 320), (44100, 1, 321)])
@pytest.mark.parametrize("log_mode,log_offset", MODES)
def test_fft_body_matches_twin_on_claps_strided_frames(sr, seconds, hop, log_mode, log_offset):
    """CLAP-LAION's and MS-CLAP's frontends as the models call them (B=2
    chunks through the strided view of the reflect-padded signal), and an
    odd hop, whose frames the body reads one float at a time."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(hop)
    chunks = torch.randn((2, sr * seconds), generator=g, device=dev) * 0.1
    bases = dmel._device_bases("torchlibrosa", dev, 1024, sr, 64, 50.0, 14000.0)
    frames = dmel.torchlibrosa_frames(chunks, 1024, hop)
    assert frames.stride(1) == hop
    assert _card_check(frames, bases, log_mode, log_offset) == "fft"


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whisper", "vggish", "clap", "random"])
@pytest.mark.parametrize("n", [1, 63, 65, 130])
def test_kernel_matches_twin_on_ragged_tiles(n, case):
    """Ragged frame tiles through the folded (Whisper's bases), the FFT
    (VGGish's: n_fft 512; CLAP's: 1024) and the unfolded (random (1024,
    513) bases) bodies."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    if case == "random":
        bases = tuple(t.to(dev) for t in _random_bases(1024, 513, 64, seed=n))
    elif case == "clap":
        bases = dmel._device_bases("torchlibrosa", dev, 1024, 48000, 64, 50.0, 14000.0)
    else:
        bases = dmel._device_bases(case, dev)
    frames = torch.randn((3, n, bases[0].shape[0]), generator=g, device=dev) * 0.1
    want = {"whisper": "folded", "random": "unfolded"}.get(case, "fft")
    assert _card_check(frames, bases, "log10_clamp") == want
    with pytest.raises(ValueError, match="unit sample stride"):
        k3.fused_log_mel(frames[:, :, ::2], *bases, log_mode="log10_clamp")
