"""The port's (dp, tp) speech evaluation step against fadtk_tpu's on the CPU.

The JAX package runs its step on the 8-device virtual CPU mesh; the port runs
one process per rank over gloo. The geometry is tests/test_parallel.py's
(hidden 64, 2 layers, 4 heads, 2000 samples) and its tolerances: n exact, mu
within 2e-5, cov within 2e-4 (the float16 round-trip of the frames, then
float32 sums in another order). The JAX parameters from ``PRNGKey(0)`` reach
the port through ``save_params`` / ``load_params`` / ``params_from_jax``.

The multi-rank cases run in gloo processes that import only torch and
``fadtk_tpu_torch``: one launch of two ranks serves every such case, and each
rank's process is joined with a timeout that fails the test.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.encoder import SpeechEncoder, speech_encoder_forward
from fadtk_tpu_torch.parallel.mesh import Mesh, make_mesh
from fadtk_tpu_torch.parallel.tp import (
    _tp_forward,
    make_sharded_eval_step,
    shard_speech_params,
)
from fadtk_tpu_torch.weights.store import load_params, params_from_jax

REPO = Path(__file__).resolve().parents[1]
CFG_KW = dict(
    conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=64,
    num_layers=2, num_heads=4, intermediate_size=128, num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, do_normalize=True,
)
VARIANTS = {  # the cases of tests/test_parallel.py that the port runs
    "standard": dict(attention_type="standard"),
    "prenorm": dict(attention_type="standard", do_stable_layer_norm=True,
                    feat_extract_norm="layer", conv_bias=True),
    "wavlm": dict(attention_type="wavlm"),
}
# (case, variant, dp, tp) of the port; the JAX side runs each on its 8-device
# mesh with the same tp.
CASES = [
    ("standard_tp1", "standard", 1, 1),
    ("standard_tp2", "standard", 1, 2),
    ("prenorm_tp2", "prenorm", 1, 2),
    ("wavlm_tp2", "wavlm", 1, 2),
    ("standard_dp2", "standard", 2, 1),
]
B, T = 8, 2000


def _cfg_kw(variant):
    return {**CFG_KW, "num_buckets": 64, "max_bucket_distance": 160,
            "feat_extract_norm": "group", **VARIANTS[variant]}


def _audio():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((B, T)).astype(np.float32) * 0.2
    num_valid = rng.integers(1200, T + 1, size=B).astype(np.int32)
    return audio, num_valid


def _port_encoder(params_file, cfg_kw):
    model = SpeechEncoder(SpeechEncoderConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(load_params(params_file)))
    return model.eval()


WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.models.speech.encoder import SpeechEncoder
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.parallel.tp import make_sharded_eval_step, shard_speech_params
from fadtk_tpu_torch.weights.store import load_params, params_from_jax

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
audio, num_valid = np.load(work / "audio.npy"), np.load(work / "num_valid.npy")
for case in json.loads((work / "cases.json").read_text()):
    cfg = SpeechEncoderConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in case["cfg"].items()})
    model = SpeechEncoder(cfg)
    model.load_state_dict(params_from_jax(load_params(work / case["params"])))
    mesh = make_mesh(tp=case["tp"])
    assert (mesh.dp, mesh.tp) == (case["dp"], case["tp"]), mesh
    step = make_sharded_eval_step(cfg, model.eval(), mesh, cfg.num_layers)
    mu, cov, n = step(shard_speech_params(model, mesh), audio, num_valid)
    np.savez(work / f"{case['name']}_rank{rank}.npz", mu=mu.numpy(), cov=cov.numpy(),
             n=n.numpy())
dist.destroy_process_group()
"""


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """The port's entry points run on the card unless asked for the CPU."""
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")


def run_gloo(worker: str, work: Path, world: int, timeout: float = 240.0) -> None:
    """Run ``worker`` in ``world`` gloo processes (argv: rank, world, port,
    work dir); each is joined with ``timeout`` and killed after it, and the
    test fails unless every rank exits 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "FADTK_TPU_TORCH_DEVICE": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(world), str(port),
                               str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX step's (mu, cov, n) for every case, and the port's: tp=1 in
    this process, the rest from one two-rank gloo launch."""
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.speech.config import SpeechEncoderConfig as JaxConfig
    from fadtk_tpu.models.speech.encoder import init_speech_encoder_params
    from fadtk_tpu.parallel.mesh import make_mesh as jax_mesh
    from fadtk_tpu.parallel.tp import make_sharded_eval_step as jax_step
    from fadtk_tpu.weights.store import save_params

    work = tmp_path_factory.mktemp("tp")
    audio, num_valid = _audio()
    np.save(work / "audio.npy", audio)
    np.save(work / "num_valid.npy", num_valid)
    want, multi, by_tp = {}, [], {}
    for name, variant, dp, tp in CASES:
        if (variant, tp) not in by_tp:  # the JAX mesh is the same 8 devices for any dp
            cfg = JaxConfig(**_cfg_kw(variant))
            params = init_speech_encoder_params(cfg, jax.random.PRNGKey(0))
            save_params(params, work / f"{variant}.npz")
            step = jax_step(cfg, params, jax_mesh(8, tp=tp), cfg.num_layers)
            by_tp[variant, tp] = tuple(np.asarray(x) for x in
                                       step(params, jnp.asarray(audio), jnp.asarray(num_valid)))
        want[name] = by_tp[variant, tp]
        if dp * tp > 1:
            multi.append(dict(name=name, cfg=_cfg_kw(variant), params=f"{variant}.npz",
                              dp=dp, tp=tp))
    (work / "cases.json").write_text(json.dumps(multi))
    run_gloo(WORKER, work, world=2)

    got = {}
    for name, variant, dp, tp in CASES:
        if dp * tp == 1:
            model = _port_encoder(work / f"{variant}.npz", _cfg_kw(variant))
            with mock.patch.dict(os.environ, {"FADTK_TPU_TORCH_DEVICE": "cpu"}):
                mesh = make_mesh()
            step = make_sharded_eval_step(model.cfg, model, mesh, model.cfg.num_layers)
            got[name] = [tuple(x.numpy() for x in step(model, audio, num_valid))]
        else:
            got[name] = []
            for r in range(2):
                z = np.load(work / f"{name}_rank{r}.npz")
                got[name].append((z["mu"], z["cov"], z["n"]))
    return {"want": want, "got": got, "work": work}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_sharded_eval_step_matches_jax(results, case):
    mu_w, cov_w, n_w = results["want"][case]
    for mu, cov, n in results["got"][case]:  # every rank holds the whole batch's stats
        assert int(n) == int(n_w)
        np.testing.assert_allclose(mu, mu_w, atol=2e-5, rtol=0)
        np.testing.assert_allclose(cov, cov_w, atol=2e-4, rtol=0)


def test_sharded_eval_step_matches_single_device_forward(results):
    """The tp=1 step against the port's own single-device forward and the
    host statistics of its float16-rounded valid frames."""
    from fadtk_tpu_torch.metric.stats import statistics_from_frame_iter

    model = _port_encoder(results["work"] / "standard.npz", _cfg_kw("standard"))
    audio, num_valid = _audio()
    with torch.no_grad():
        states, mask = speech_encoder_forward(model, torch.from_numpy(audio),
                                              torch.from_numpy(num_valid))
    frames = states[-1].numpy()
    frame_list = [frames[i, mask[i].numpy() > 0].astype(np.float16).astype(np.float64)
                  for i in range(B)]
    mu_ref, cov_ref = statistics_from_frame_iter(iter(frame_list), 64)
    mu, cov, n = results["got"]["standard_tp1"][0]
    assert int(n) == sum(f.shape[0] for f in frame_list)
    np.testing.assert_allclose(mu, mu_ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(cov, cov_ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_bit_equal_to_jax_named_sharding(results, tp):
    """Each tp rank's shard-local encoder holds exactly the block of every
    leaf that JAX's NamedSharding gives the device at (dp 0, tp rank) of the
    8-device mesh, replicated leaves whole."""
    import jax
    from jax.sharding import NamedSharding

    from fadtk_tpu.models.speech.config import SpeechEncoderConfig as JaxConfig
    from fadtk_tpu.parallel.mesh import make_mesh as jax_mesh
    from fadtk_tpu.parallel.tp import speech_param_specs
    from fadtk_tpu.weights.store import load_params as jax_load

    path = results["work"] / "wavlm.npz"
    params = jax_load(path)
    jmesh = jax_mesh(8, tp=tp)
    specs = speech_param_specs(JaxConfig(**_cfg_kw("wavlm")), params)
    placed = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(jmesh, s)), params, specs)
    model = _port_encoder(path, _cfg_kw("wavlm"))
    for rank in range(tp):
        device = jmesh.devices[0, rank]

        def local(x, device=device):
            return next(np.asarray(s.data) for s in x.addressable_shards if s.device == device)

        want = params_from_jax(jax.tree.map(local, placed))
        mesh = Mesh(dp=1, tp=tp, dp_rank=0, tp_rank=rank, device=torch.device("cpu"))
        got = shard_speech_params(model, mesh).state_dict()
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].shape == value.shape, key
            assert torch.equal(got[key], value), key
    assert shard_speech_params(model, make_mesh()) is model  # tp=1: the encoder itself


def test_bf16_wavlm_step_reaches_k2_twin(results, monkeypatch):
    """bf16 WavLM with the flash kernels forced on: the tp path's attention
    goes to K2 (its twin on the CPU) on the head-split views, once per layer.
    Its frames agree with the port's single-device bf16 forward (K1b's twin,
    held against the JAX package's bf16 forward by tests/test_torch_wavlm.py)
    within the bf16 bound of the earlier slices (0.15 on hidden states of
    magnitude ~4). K2's twin is held against JAX's kernel directly in
    tests/test_torch_flash_attention_headmajor.py, not through JAX's
    memoised step, whose trace would not see the environment variable."""
    from fadtk_tpu_torch.ops import flash_attention as fa

    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "1")
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, n_valid=None, position_bias=None, gate=None, **kw):
        calls.append((q.shape, q.is_contiguous(), position_bias.dtype, gate.dtype))
        return real(q, k, v, n_valid, position_bias, gate, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    model = _port_encoder(results["work"] / "wavlm.npz", _cfg_kw("wavlm")).to(torch.bfloat16)
    audio, num_valid = _audio()
    mesh = make_mesh()
    with torch.no_grad():
        got, mask = _tp_forward(model.cfg, model, torch.from_numpy(audio),
                                torch.from_numpy(num_valid), mesh, model.cfg.num_layers)
        single, smask = speech_encoder_forward(model, torch.from_numpy(audio),
                                               torch.from_numpy(num_valid))
        mu, cov, n = make_sharded_eval_step(model.cfg, model, mesh, 2)(model, audio, num_valid)
    assert len(calls) == 2 * model.cfg.num_layers  # the tp forward and the step
    assert all(c[1] is False and c[2] == c[3] == torch.float32 for c in calls)
    assert got.dtype == torch.bfloat16 and torch.equal(mask, smask)
    for i in range(B):
        nv = int(mask[i].float().sum())
        np.testing.assert_allclose(got[i, :nv].float().numpy(), single[-1, i, :nv].float().numpy(),
                                   atol=0.15, rtol=0)
    assert int(n) == int(mask.float().sum()) and torch.isfinite(cov).all()


@pytest.mark.parametrize("offset", [0, 1])
def test_f32_step_reads_flash_min_t(results, monkeypatch, offset):
    """f32 with ``FADTK_TPU_FLASH_F32=1``: the tp step's standard attention
    takes K1 (its twin on the CPU, forced on) once per layer where T reaches
    ``FADTK_TPU_FLASH_F32_MIN_T`` and the plain path one frame below it, as
    the JAX package's ``use_flash_attention`` decides."""
    import jax.numpy as jnp

    from fadtk_tpu.models.speech.encoder import use_flash_attention as jax_routing
    from fadtk_tpu_torch.ops import flash_attention as fa

    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "1")
    monkeypatch.setenv("FADTK_TPU_FLASH_F32", "1")
    calls = []
    real = fa.flash_attention_packed

    def spy(q, *args, **kw):
        calls.append(q.shape[1])
        return real(q, *args, **kw)

    monkeypatch.setattr(fa, "flash_attention_packed", spy)
    model = _port_encoder(results["work"] / "standard.npz", _cfg_kw("standard"))
    audio, num_valid = _audio()
    t = T
    for kernel, stride in zip(model.cfg.conv_kernel, model.cfg.conv_stride):
        t = (t - kernel) // stride + 1  # the feature extractor's frames
    monkeypatch.setenv("FADTK_TPU_FLASH_F32_MIN_T", str(t + offset))
    want = jax_routing(jnp.float32, jnp.ones(B, jnp.int32), t)
    with torch.no_grad():
        got, _ = _tp_forward(model.cfg, model, torch.from_numpy(audio),
                             torch.from_numpy(num_valid), make_mesh(), model.cfg.num_layers)
    assert want is (offset == 0)
    assert calls == ([t] * model.cfg.num_layers if want else [])
    assert got.dtype == torch.float32 and torch.isfinite(got).all()


def test_step_refuses_a_cfg_that_differs_and_a_batch_dp_must_divide(results):
    model = _port_encoder(results["work"] / "standard.npz", _cfg_kw("standard"))
    mesh = make_mesh()
    other = SpeechEncoderConfig(**_cfg_kw("prenorm"))
    with pytest.raises(ValueError, match="differs"):
        make_sharded_eval_step(other, model, mesh, 1)
    with pytest.raises(ValueError, match="must divide"):
        make_sharded_eval_step(model.cfg, model, Mesh(2, 1, 0, 0, torch.device("cpu")), 1)(
            model, np.zeros((3, T), np.float32), np.ones(3, np.int32))


def test_make_mesh_single_process(monkeypatch):
    """No process group: dp = tp = 1 on the chosen device; more devices or
    tp > 1 need a torchrun launch (one process per GPU). The device is the
    card unless FADTK_TPU_TORCH_DEVICE asks for the CPU."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.rank, mesh.device.type) == (1, 1, 0, "cpu")
    assert mesh.dp_group is None and mesh.tp_group is None
    assert make_mesh(1) == mesh
    with pytest.raises(SystemExit, match="torchrun"):
        make_mesh(2)
    with pytest.raises(SystemExit, match="torchrun"):
        make_mesh(tp=2)
    monkeypatch.delenv("FADTK_TPU_TORCH_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="FADTK_TPU_TORCH_DEVICE=cpu"):
            make_mesh()
