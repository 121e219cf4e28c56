"""Host layer of the PyTorch port (fadtk_tpu_torch) against fadtk_tpu on the CPU.

Every host function that the port copies from the JAX package must give the
same bits: cache paths, WAV I/O and decode, the Kaiser resampler, the weight
store, statistics and the host Frechet evaluators. The device Newton-Schulz
evaluator is float32 and compared at a stated relative tolerance.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fadtk_tpu_torch import utils as tu
from fadtk_tpu_torch.audio import decode as tdecode
from fadtk_tpu_torch.audio.wavio import float_to_int16, read_wav_int16, write_wav_int16
from fadtk_tpu_torch.dsp.resample import resample_kaiser, resampled_length
from fadtk_tpu_torch.metric import frechet as tfrechet
from fadtk_tpu_torch.metric import stats as tstats
from fadtk_tpu_torch.weights import store as tstore

REPO = Path(__file__).resolve().parents[1]


def _cov(rng, d, n=400):
    x = rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3
    return x.mean(0), np.cov(x, rowvar=False)


def test_cache_paths_match_jax_package(tmp_path):
    from fadtk_tpu import utils as ju

    f = tmp_path / "ds" / "song.opus"
    assert tu.get_cache_embedding_path("w2v2-base-bf16", f) == ju.get_cache_embedding_path(
        "w2v2-base-bf16", f
    )
    assert tu.get_convert_cache_path(16000, f) == ju.get_convert_cache_path(16000, f)
    assert tu.get_stats_cache_dir(f.parent, "m") == ju.get_stats_cache_dir(f.parent, "m")
    (tmp_path / "ds").mkdir()
    for name in ("b.wav", "a.flac", "noext"):
        (tmp_path / "ds" / name).write_bytes(b"x")
    (tmp_path / "ds" / "sub.d").mkdir()
    assert tu.dataset_files(tmp_path / "ds") == ju.dataset_files(tmp_path / "ds")
    assert [tu.next_multiple(x, 160000) for x in (1, 160000, 160001)] == [
        160000, 160000, 320000,
    ]


def test_resolve_device(monkeypatch):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    assert tu.resolve_device() == torch.device("cpu")
    # No card and the default device: raise, never carry on on the CPU.
    monkeypatch.delenv("FADTK_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FADTK_TPU_TORCH_DEVICE=cpu"):
        tu.resolve_device()


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_bit_equal_to_libav(tmp_path, channels):
    """The port reads 16-bit PCM WAV in numpy; it must equal what the JAX
    package's libav decoder returns for the same file, bit for bit."""
    from fadtk_tpu.audio.decode import decode_audio as jax_decode

    rng = np.random.default_rng(channels)
    pcm = rng.integers(-32768, 32768, size=(9001, channels), dtype=np.int16)
    pcm[:4] = [[-32768] * channels, [32767] * channels, [0] * channels, [-1] * channels]
    path = tmp_path / "x.wav"
    write_wav_int16(path, pcm[:, 0] if channels == 1 else pcm, 22050)

    got, sr = tdecode.decode_audio(path)
    want, want_sr = jax_decode(path)
    assert sr == want_sr == 22050
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (channels, 9001)
    np.testing.assert_array_equal(got, want)

    data, rate = read_wav_int16(path)
    assert rate == 22050 and data.shape[0] == 9001


def test_non_wav_without_decoder_names_the_problem(tmp_path, monkeypatch):
    native = tmp_path / "native"
    native.mkdir()
    (native / "decode.cc").write_text("// source\n")
    (native / "build.sh").write_text("echo 'fatal error: libavcodec/avcodec.h' >&2; exit 1\n")
    monkeypatch.setattr(tdecode, "_NATIVE_DIR", native)
    monkeypatch.setattr(tdecode, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdecode, "_LIB", None)
    monkeypatch.delenv("FADTK_TPU_NATIVE_LIB", raising=False)
    song = tmp_path / "song.mp3"
    song.write_bytes(b"ID3 not a wav")
    with pytest.raises(RuntimeError, match="FFmpeg development libraries.*avcodec.h"):
        tdecode.decode_audio(song)


@pytest.mark.parametrize("sr_in", [44100, 48000])
def test_resample_kaiser_bit_equal(sr_in):
    from fadtk_tpu.dsp.resample import resample_kaiser as jax_resample

    rng = np.random.default_rng(sr_in)
    x = (0.3 * rng.standard_normal(sr_in + 777)).astype(np.float32)
    got = resample_kaiser(x, sr_in, 16000)
    np.testing.assert_array_equal(got, jax_resample(x, sr_in, 16000))
    assert got.shape == (resampled_length(x.shape[0], sr_in, 16000),)
    np.testing.assert_array_equal(float_to_int16(got), float_to_int16(jax_resample(x, sr_in, 16000)))


def test_weight_store_round_trip(tmp_path):
    from fadtk_tpu.weights.store import save_params

    rng = np.random.default_rng(0)
    tree = {
        "dense": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                  "bias": np.zeros(5, np.float32)},
        "conv_layers": [{"conv": {"kernel": rng.standard_normal((10, 1, 4)).astype(np.float32)},
                         "layer_norm": {"scale": np.ones(4, np.float32),
                                        "bias": np.zeros(4, np.float32)}}],
        "__config__": np.frombuffer(b'{"conv_dim": [4], "do_normalize": false}', np.uint8),
    }
    path = tmp_path / "m.npz"
    save_params(tree, path)
    assert set(tstore.flatten_pytree(tree)) == set(np.load(path).files)
    loaded = tstore.load_params(path)
    meta = loaded.pop("__config__")
    assert tstore.decode_config_meta(meta) == {"conv_dim": (4,), "do_normalize": False}
    np.testing.assert_array_equal(loaded["conv_layers"][0]["conv"]["kernel"],
                                  tree["conv_layers"][0]["conv"]["kernel"])
    assert tstore.unflatten_pytree(tstore.flatten_pytree(loaded))["dense"].keys() == {"kernel", "bias"}

    state = tstore.params_from_jax(loaded)
    assert state["dense.weight"].shape == (5, 3)
    np.testing.assert_array_equal(state["dense.weight"].numpy(), tree["dense"]["kernel"].T)
    assert state["conv_layers.0.conv.weight"].shape == (4, 1, 10)
    np.testing.assert_array_equal(
        state["conv_layers.0.conv.weight"].numpy(),
        tree["conv_layers"][0]["conv"]["kernel"].transpose(2, 1, 0),
    )
    assert set(state) == {"dense.weight", "dense.bias", "conv_layers.0.conv.weight",
                          "conv_layers.0.layer_norm.weight", "conv_layers.0.layer_norm.bias"}


def test_params_path_and_random_flag(monkeypatch, tmp_path):
    from fadtk_tpu.weights import store as jstore

    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path))
    assert tstore.params_path("facebook__wav2vec2-base-960h") == jstore.params_path(
        "facebook__wav2vec2-base-960h"
    )
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    assert tstore.random_weights_enabled()


def test_stats_bit_equal(tmp_path):
    from fadtk_tpu.metric import stats as jstats

    rng = np.random.default_rng(1)
    files = []
    for i, n in enumerate((7, 31, 2, 50)):
        f = tmp_path / f"e{i}.npy"
        np.save(f, rng.standard_normal((n, 24)).astype(np.float16))
        files.append(f)
    for a, b in zip(tstats.calculate_embd_statistics_online(files),
                    jstats.calculate_embd_statistics_online(files)):
        np.testing.assert_array_equal(a, b)
    frames = [np.load(f) for f in files]
    for a, b in zip(tstats.statistics_from_frame_iter(iter(frames), 24),
                    jstats.statistics_from_frame_iter(iter(frames), 24)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tstats.calc_embd_statistics(frames[1]), jstats.calc_embd_statistics(frames[1])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tstats.file_partial_stats(files[3]), jstats.file_partial_stats(files[3])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["eigh", "reference"])
def test_host_frechet_bit_equal(method):
    from fadtk_tpu.metric import frechet as jfrechet

    rng = np.random.default_rng(2)
    mu1, c1 = _cov(rng, 16)
    mu2, c2 = _cov(rng, 16)
    got = tfrechet.frechet_distance(mu1, c1, mu2.astype(np.float16), c2, method=method)
    want = jfrechet.frechet_distance(mu1, c1, mu2.astype(np.float16), c2, method=method)
    assert got == want
    assert tfrechet.FrechetBaseline(mu1, c1).distance(mu2, c2) == jfrechet.FrechetBaseline(
        mu1, c1
    ).distance(mu2, c2)


def test_newton_schulz_close_to_jax_and_eigh():
    """float32 Newton-Schulz in torch vs the JAX package's jitted one and the
    float64 eigh value: within 1e-4 relative (both are 30-iteration float32
    iterations; summation order differs between the frameworks)."""
    from fadtk_tpu.metric import frechet as jfrechet

    rng = np.random.default_rng(3)
    mu1, c1 = _cov(rng, 32)
    mu2, c2 = _cov(rng, 32)
    got = tfrechet.frechet_distance(mu1, c1, mu2, c2, method="newton_schulz",
                                    device=torch.device("cpu"))
    want = jfrechet.frechet_distance(mu1, c1, mu2, c2, method="newton_schulz")
    exact = tfrechet.frechet_distance(mu1, c1, mu2, c2, method="eigh")
    assert abs(got - want) <= 1e-4 * abs(want)
    assert abs(got - exact) <= 1e-4 * abs(exact)
    tr = tfrechet.trace_sqrtm_product_ns(torch.tensor(c1, dtype=torch.float32),
                                         torch.tensor(c2, dtype=torch.float32))
    want_tr = float(jfrechet.trace_sqrtm_product_ns(jnp.asarray(c1, jnp.float32),
                                                    jnp.asarray(c2, jnp.float32)))
    assert abs(float(tr) - want_tr) <= 1e-4 * abs(want_tr)
    dev = tfrechet.frechet_distance_device(
        *(torch.tensor(a, dtype=torch.float32) for a in (mu1, c1, mu2, c2))
    )
    assert abs(float(dev) - exact) <= 1e-4 * abs(exact)


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked, the device
    pipeline's (parallel.mesh, parallel.tp, runner.device_pipeline,
    runner.convert, runner.resume) among them."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import fadtk_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(fadtk_tpu_torch.__path__, 'fadtk_tpu_torch.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "want = {'fadtk_tpu_torch.parallel.mesh', 'fadtk_tpu_torch.parallel.tp',\n"
        "        'fadtk_tpu_torch.runner.device_pipeline', 'fadtk_tpu_torch.runner.convert',\n"
        "        'fadtk_tpu_torch.runner.resume'}\n"
        "assert want <= set(mods), want - set(mods)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'fadtk_tpu.')) for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_port_sources_never_import_jax():
    pkg = REPO / "fadtk_tpu_torch"
    for f in [*pkg.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import fadtk_tpu.",
                                     "from fadtk_tpu.", "from fadtk_tpu ")), f"{f}: {s}"
