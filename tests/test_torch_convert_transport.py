"""The port's device convert transport (``FADTK_TPU_CONVERT_TRANSPORT=device``)
against the JAX package's, on the CPU.

- ``dsp/resample.py::convert_device`` against ``fadtk_tpu.dsp.resample``'s on
  the same seeded inputs, int16 and float32, at 44.1k->16k, 48k->24k and
  22.05k->16k: before quantization within 1e-6 on rows at real-audio level
  (the two products sum in other orders), after it at most 1 LSB apart with
  at least 99.5% of samples equal, a row past full scale included;
- equal rates are the identity; truncating the source at
  ``source_samples_needed`` leaves the output prefix bit-identical; shipping
  int16 is bit-equal to shipping float32;
- ``ClipLoader`` under the device transport against the host transport and
  against the JAX package's device transport, on a fresh dataset (1 LSB, at
  least 99.5% equal), with the same-rate int16-exact identity sending
  nothing to the device; the env validation;
- ``--device-pipeline`` statistics on a fresh dataset, device against host
  transport (the pipeline's float32 bounds, mu 1e-3 and cov 5e-3);
- the host decode pool (``convert.DecodePool``): its threads resample with
  numpy's OpenBLAS ``max(1, cores // workers)`` wide, the calling thread's
  width is back once a window ends, the loader is closed early or a decode
  raises; at the CLI's 8 workers the loader's host-transport clips equal bit
  for bit the int16 the cached path's pool writes to the convert cache.
"""

import shutil

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.audio.wavio import float_to_int16, read_wav_int16, write_wav_int16
from fadtk_tpu_torch.dsp import resample as port
from fadtk_tpu_torch.runner import convert

from test_torch_device_pipeline import CFG, COV_ATOL, MU_ATOL, tiny_model

RATES = [(44100, 16000), (48000, 24000), (22050, 16000)]
PRE_QUANT_ATOL = 1e-6
MIN_EXACT = 0.995
LSB = 1.0 / 32768.0


def _tone(sr, seconds, seed, noise=0.02):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 2000) * t)
    return (x + noise * rng.standard_normal(t.shape[0])).astype(np.float32)


def _lsb_check(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff == 0).mean() >= MIN_EXACT, (diff.max(), (diff == 0).mean())


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.delenv("FADTK_TPU_CONVERT_TRANSPORT", raising=False)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("rates", RATES, ids=[f"{a}-{b}" for a, b in RATES])
def test_convert_device_matches_jax(rates, dtype):
    import jax.numpy as jnp

    from fadtk_tpu.dsp import resample as ref

    sr_in, sr_out = rates
    rng = np.random.default_rng(sr_in)
    # Two rows at a level real audio has, and a third driven past full scale
    # so the clamp runs (held after quantization only: the two products'
    # sums differ by a few float32 ulps of values near 1).
    x = np.stack([_tone(sr_in, 0.9, 1), _tone(sr_in, 0.9, 2, noise=0.1),
                  _tone(sr_in, 0.9, 3, noise=0.3) * 2.5])
    x[:, -1000:] = 0.0
    if dtype == "int16":
        x = float_to_int16(np.clip(x, -1, 1))
    else:
        x = (x + rng.standard_normal(x.shape).astype(np.float32) * 1e-4).astype(np.float32)
    xf = x.astype(np.float32) / 32768.0 if dtype == "int16" else x

    pre = port.resample_batch(torch.from_numpy(xf), sr_in, sr_out).numpy()
    pre_ref = np.asarray(ref.resample_batch(jnp.asarray(xf), sr_in, sr_out))
    np.testing.assert_allclose(pre[:2], pre_ref[:2], atol=PRE_QUANT_ATOL, rtol=0)

    got = port.convert_device(torch.from_numpy(x), sr_in, sr_out)
    want = np.asarray(ref.convert_device(jnp.asarray(x), sr_in, sr_out))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    _lsb_check(got.numpy(), want)
    # And against the host convert path (the cache writer's).
    _lsb_check(got.numpy(), float_to_int16(port.resample_kaiser(xf, sr_in, sr_out)))


def test_equal_rates_are_the_identity():
    q = float_to_int16(_tone(16000, 0.7, 4))
    assert torch.equal(port.convert_device(torch.from_numpy(q[None]), 16000, 16000)[0],
                       torch.from_numpy(q))
    f = _tone(16000, 0.7, 5, noise=0.1)
    got = port.convert_device(torch.from_numpy(f[None]), 16000, 16000)[0].numpy()
    np.testing.assert_array_equal(got, float_to_int16(f))
    x = torch.from_numpy(f[None])
    assert port.resample_batch(x, 16000, 16000) is x


@pytest.mark.parametrize("rates", RATES, ids=[f"{a}-{b}" for a, b in RATES])
def test_source_samples_needed_prefix_is_exact(rates):
    from fadtk_tpu.dsp import resample as ref

    sr_in, sr_out = rates
    x = torch.from_numpy(_tone(sr_in, 2.0, 6)[None])
    full = port.resample_batch(x, sr_in, sr_out)[0]
    n_out = sr_out // 2
    n_src = port.source_samples_needed(n_out, sr_in, sr_out)
    assert n_src == ref.source_samples_needed(n_out, sr_in, sr_out) < x.shape[1]
    cut = port.resample_batch(x[:, :n_src], sr_in, sr_out)[0]
    assert torch.equal(cut[:n_out], full[:n_out])


def test_bucket_padding_prefix_is_exact():
    x = _tone(44100, 1.3, 7)
    padded = np.zeros((1, 44100 * 2), np.float32)
    padded[0, : x.shape[0]] = x
    exact = port.convert_device(torch.from_numpy(x[None]), 44100, 16000)[0]
    pad = port.convert_device(torch.from_numpy(padded), 44100, 16000)[0]
    assert torch.equal(pad[: exact.shape[0]], exact)


def test_int16_shipping_is_bit_equal_to_float():
    q = float_to_int16(_tone(44100, 1.7, 3))
    f = (q / 32768.0).astype(np.float32)
    via_i16 = port.convert_device(torch.from_numpy(q[None]), 44100, 16000)
    via_f32 = port.convert_device(torch.from_numpy(f[None]), 44100, 16000)
    assert torch.equal(via_i16, via_f32)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """A mixed-rate, mixed-channel dataset without convert caches: 44.1 kHz,
    48 kHz stereo, 22.05 kHz, 16 kHz, and one clip at the tiny model's 8 kHz
    (the identity)."""
    d = tmp_path_factory.mktemp("fresh")
    write_wav_int16(d / "a_44k.wav", float_to_int16(_tone(44100, 1.6, 10)), 44100)
    stereo = np.stack([_tone(48000, 1.1, 11), _tone(48000, 1.1, 12)], axis=1)
    write_wav_int16(d / "b_48k_stereo.wav", float_to_int16(stereo), 48000)
    write_wav_int16(d / "c_22k.wav", float_to_int16(_tone(22050, 0.8, 13)), 22050)
    write_wav_int16(d / "d_16k.wav", float_to_int16(_tone(16000, 1.2, 14)), 16000)
    write_wav_int16(d / "e_8k.wav", float_to_int16(_tone(8000, 0.9, 15)), 8000)
    return d


def _to_int16(clip: np.ndarray) -> np.ndarray:
    """A model-ready clip (int16 / 32768) back to int16."""
    return np.round(clip * 32768.0).astype(np.int64)


def test_clip_loader_device_matches_host_transport(fresh, monkeypatch):
    model = tiny_model()
    files = sorted(fresh.glob("*.wav"))
    calls = []
    real = port.convert_device

    def counted(x, sr_in, sr_out):
        calls.append((x.dtype, sr_in, x.shape))
        return real(x, sr_in, sr_out)

    monkeypatch.setattr(port, "convert_device", counted)
    dev = list(convert.ClipLoader(model, workers=2, transport="device").iter_clips(files))
    host = list(convert.ClipLoader(model, workers=2, transport="host").iter_clips(files))
    assert not list(fresh.glob("convert/**/*.wav")), "misses must not write the cache"
    for f, d, h in zip(files, dev, host):
        assert d.dtype == h.dtype and d.shape == h.shape
        if f.name == "e_8k.wav":  # at rate and int16 exact: untouched
            assert np.array_equal(d, h)
        else:
            _lsb_check(_to_int16(d), _to_int16(h))
    # One batch per (source rate, bucket), int16 shipped (every source is a
    # 16-bit wav; the stereo mean of two int16 channels is not 16-bit exact),
    # and nothing for the 8 kHz clip.
    assert sorted(c[1] for c in calls) == [16000, 22050, 44100, 48000]
    assert {c[1]: c[0] for c in calls}[44100] == torch.int16
    assert {c[1]: c[0] for c in calls}[48000] == torch.float32
    assert all(c[2][0] == convert.rows_for_bucket(c[2][1]) for c in calls)


def test_clip_loader_device_matches_jax_device_transport(fresh):
    """The port's loader and the JAX package's, both under the device
    transport, for a 16 kHz model (VGGish): 1 LSB, 99.5% equal."""
    from fadtk_tpu.models.vggish import VGGishModel as JaxVGGish
    from fadtk_tpu.runner.convert import ClipLoader as JaxLoader

    from fadtk_tpu_torch.models.vggish import VGGishModel

    files = sorted(fresh.glob("*.wav"))
    got = list(convert.ClipLoader(VGGishModel(), workers=2, transport="device")
               .iter_clips(files))
    want = list(JaxLoader(JaxVGGish(), workers=2, transport="device").iter_clips(files))
    for g, w in zip(got, want):
        _lsb_check(_to_int16(np.asarray(g)), _to_int16(np.asarray(w)))


def test_transport_env_validation(monkeypatch):
    model = tiny_model()
    monkeypatch.setenv("FADTK_TPU_CONVERT_TRANSPORT", "device")
    assert convert.ClipLoader(model).transport == "device"
    assert convert.ClipLoader(model, transport="host").transport == "host"
    monkeypatch.delenv("FADTK_TPU_CONVERT_TRANSPORT")
    assert convert.ClipLoader(model).transport == "host"
    for bad in ("disk", "DEVICE", ""):
        monkeypatch.setenv("FADTK_TPU_CONVERT_TRANSPORT", bad)
        with pytest.raises(ValueError, match="must be 'device' or 'host'"):
            convert.ClipLoader(model)


def test_device_pipeline_stats_device_vs_host_transport(fresh, tmp_path, monkeypatch):
    from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device

    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.setenv("FADTK_TPU_CKPT", "0")
    stats = {}
    for transport in ("device", "host"):
        d = tmp_path / transport
        shutil.copytree(fresh, d)
        monkeypatch.setenv("FADTK_TPU_CONVERT_TRANSPORT", transport)
        stats[transport] = dataset_stats_device(tiny_model(), d, batch=2, workers=2)
        assert not (d / "convert").exists() and not (d / "embeddings").exists()
    (mu_d, cov_d, n_d), (mu_h, cov_h, n_h) = stats["device"], stats["host"]
    lengths = [int(np.ceil(n * 8000 / sr)) for n, sr in
               ((int(44100 * 1.6), 44100), (int(48000 * 1.1), 48000),
                (int(22050 * 0.8), 22050), (int(16000 * 1.2), 16000), (int(8000 * 0.9), 8000))]
    assert n_d == n_h == sum(CFG.num_output_frames(n) for n in lengths)
    np.testing.assert_allclose(mu_d, mu_h, atol=MU_ATOL, rtol=0)
    np.testing.assert_allclose(cov_d, cov_h, atol=COV_ATOL, rtol=0)


def _openblas():
    blas = convert.numpy_openblas()
    if blas is None:
        pytest.skip("numpy here runs on no OpenBLAS with a thread-count setter")
    return blas


@pytest.mark.parametrize("workers", [1, 8])
def test_decode_pool_runs_blas_at_its_width(fresh, monkeypatch, workers):
    blas = _openblas()
    before = blas.get()
    want = min(before, max(1, convert.usable_cores() // workers))
    seen = []
    real = convert.convert_audio

    def spy(f, sr):
        seen.append(blas.get())
        return real(f, sr)

    monkeypatch.setattr(convert, "convert_audio", spy)
    files = sorted(fresh.glob("*.wav")) * 2  # 10 misses: two windows of 8 at one worker
    clips = convert.ClipLoader(tiny_model(), workers=workers, transport="host").iter_clips(files)
    next(clips)
    assert blas.get() == before
    clips.close()
    assert blas.get() == before
    assert len(seen) == (8 if workers == 1 else 10) and set(seen) == {want}

    def broken(f, sr):
        raise OSError(f"cannot decode {f}")

    monkeypatch.setattr(convert, "convert_audio", broken)
    with pytest.raises(OSError, match="cannot decode"):
        list(convert.ClipLoader(tiny_model(), workers=workers, transport="host")
             .iter_clips(files))
    assert blas.get() == before


def test_loader_clips_equal_the_cached_paths_convert_at_8_workers(tmp_path):
    """44.1 kHz stereo songs to the tiny model's 8 kHz, where one BLAS thread
    and eight give int16 a few LSBs apart."""
    from fadtk_tpu_torch.runner.batch import cache_embedding_files
    from fadtk_tpu_torch.utils import get_convert_cache_path

    cached, loaded = tmp_path / "cached", tmp_path / "loaded"
    for d in (cached, loaded):
        d.mkdir()
    for i, seconds in enumerate((1.9, 1.3, 1.6, 0.9)):
        stereo = np.stack([_tone(44100, seconds, 20 + i), _tone(44100, seconds, 30 + i)], axis=1)
        for d in (cached, loaded):
            write_wav_int16(d / f"s{i}.wav", float_to_int16(stereo), 44100)
    model = tiny_model()
    cache_embedding_files(cached, model, workers=8)
    clips = convert.ClipLoader(model, workers=8, transport="host").iter_clips(
        sorted(loaded.glob("*.wav")))
    for f, clip in zip(sorted(cached.glob("*.wav")), clips):
        written, sr = read_wav_int16(get_convert_cache_path(model.sr, f))
        assert sr == model.sr
        assert np.array_equal(_to_int16(clip), written), f.name
