"""The port's tensor-parallel Whisper step (``parallel/whisper_tp.py``) on the
CPU, against the port's plain ``whisper_forward`` and the JAX package's
``make_sharded_whisper_step`` on the same weights (the JAX tree carried
across with ``params_from_jax``), at the tiny config of
tests/test_whisper_tp.py with nonzero biases everywhere:

- tp = 1 in this process, (dp, tp) = (1, 2) over two gloo processes and
  (2, 2) over four (127.0.0.1, joined with a timeout): float32 within 1e-5
  of the largest value;
- the row-parallel biases (out_proj, fc2) are added once, after the
  reduce: the sharded step matches the plain forward, and a forward with
  those biases doubled is far outside the tolerance;
- the shard splits q/k/v and fc1 by columns (k_proj without bias), out_proj
  and fc2 by rows, and refuses a tp that does not divide the heads.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.whisper_impl import Whisper, WhisperConfig, whisper_forward
from fadtk_tpu_torch.parallel.mesh import Mesh
from fadtk_tpu_torch.parallel.whisper_tp import make_sharded_whisper_step, shard_whisper_params
from fadtk_tpu_torch.weights.store import load_params, params_from_jax

from test_torch_tp import run_gloo

TINY = dict(
    d_model=32, encoder_layers=2, encoder_heads=4, decoder_layers=2,
    decoder_heads=4, encoder_ffn=64, decoder_ffn=64, num_mel_bins=16,
    max_source_positions=64, max_target_positions=8, vocab_size=100,
    decoder_start_token_id=7,
)
RTOL = 1e-5  # of the largest output value
BIAS_LEAVES = ("bias",)

WORKER = r"""
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from fadtk_tpu_torch.models.whisper_impl import Whisper, WhisperConfig
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.parallel.whisper_tp import make_sharded_whisper_step, shard_whisper_params
from fadtk_tpu_torch.weights.store import load_params, params_from_jax

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world)
tree = load_params(work / "whisper.npz")
cfg = WhisperConfig(**{k: int(v) for k, v in np.load(work / "cfg.npz").items()})
model = Whisper(cfg)
model.load_state_dict(params_from_jax(tree))
mesh = make_mesh(tp=2)
assert (mesh.dp, mesh.tp) == (world // 2, 2), mesh
out = make_sharded_whisper_step(cfg, mesh)(shard_whisper_params(model, mesh),
                                           np.load(work / "feats.npy"))
np.save(work / f"out{world}_rank{rank}.npy", out.numpy())
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.whisper_impl import WhisperConfig as JaxConfig
    from fadtk_tpu.models.whisper_impl import init_whisper_params
    from fadtk_tpu.models.whisper_impl import whisper_forward as jax_forward
    from fadtk_tpu.parallel.mesh import make_mesh as jax_mesh
    from fadtk_tpu.parallel.whisper_tp import make_sharded_whisper_step as jax_step
    from fadtk_tpu.weights.store import flatten_pytree, save_params, unflatten_pytree

    work = tmp_path_factory.mktemp("whisper_tp")
    jcfg = JaxConfig(**TINY)
    params = init_whisper_params(jcfg, jax.random.PRNGKey(0))
    # Nonzero biases everywhere (the init's are zero), so a bias added on
    # every rank instead of once would show.
    rng = np.random.default_rng(3)
    flat = {k: (np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.float32) * 0.2
                if k.endswith("/bias") else np.asarray(v))
            for k, v in flatten_pytree(params).items()}
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_pytree(flat))
    save_params(params, work / "whisper.npz")
    np.savez(work / "cfg.npz", **TINY)
    feats = (rng.standard_normal((4, 16, 128)) * 0.3).astype(np.float32)
    np.save(work / "feats.npy", feats)

    step = jax_step(jcfg, params, jax_mesh(8, tp=2))
    jax_tp = np.asarray(step(params, jnp.asarray(feats)))
    jax_plain = np.asarray(jax_forward(jcfg, params, jnp.asarray(feats)))

    model = Whisper(WhisperConfig(**TINY))
    model.load_state_dict(params_from_jax(load_params(work / "whisper.npz")))
    with torch.inference_mode():
        plain = whisper_forward(model, torch.from_numpy(feats)).numpy()
    one = Mesh(dp=1, tp=1, dp_rank=0, tp_rank=0, device=torch.device("cpu"))
    tp1 = make_sharded_whisper_step(model.cfg, one)(shard_whisper_params(model, one),
                                                    torch.from_numpy(feats)).numpy()
    for world in (2, 4):
        run_gloo(WORKER, work, world=world)
    gloo = {world: [np.load(work / f"out{world}_rank{r}.npy") for r in range(world)]
            for world in (2, 4)}
    return {"model": model, "feats": feats, "jax_tp": jax_tp, "jax_plain": jax_plain,
            "plain": plain, "tp1": tp1, "gloo": gloo}


def _close(got, want):
    assert got.shape == want.shape == (4, 2, TINY["d_model"])
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_tp1_matches_plain_and_jax(results):
    _close(results["plain"], results["jax_plain"])
    _close(results["tp1"], results["plain"])
    _close(results["tp1"], results["jax_tp"])


@pytest.mark.parametrize("world", [2, 4], ids=["dp1-tp2", "dp2-tp2"])
def test_tp2_over_gloo_matches_plain_and_jax(results, world):
    outs = results["gloo"][world]
    for out in outs:  # every rank holds the whole batch, gathered over dp
        np.testing.assert_array_equal(out, outs[0])
        _close(out, results["plain"])
        _close(out, results["jax_tp"])


def test_row_parallel_biases_are_added_once(results):
    """Doubling out_proj's and fc2's biases (what adding them on both tp
    ranks would do) moves the output far past the tolerance; the tp = 2
    step stays on the plain forward."""
    import copy

    doubled = copy.deepcopy(results["model"])
    with torch.no_grad():
        for layer in [*doubled.encoder.layers, *doubled.decoder.layers]:
            for name in ("self_attn", "encoder_attn"):
                if name in layer:
                    layer[name].out_proj.bias.mul_(2)
            layer["fc2"].bias.mul_(2)
        wrong = whisper_forward(doubled, torch.from_numpy(results["feats"])).numpy()
    plain = results["plain"]
    assert np.abs(wrong - plain).max() > 100 * RTOL * np.abs(plain).max()
    _close(results["gloo"][2][0], plain)


def test_shard_layout(results):
    model = results["model"]
    mesh = Mesh(dp=1, tp=2, dp_rank=0, tp_rank=1, device=torch.device("cpu"))
    shard = shard_whisper_params(model, mesh)
    full, part = model.decoder.layers[0], shard.decoder.layers[0]
    for name in ("self_attn", "encoder_attn"):
        for proj in ("q_proj", "k_proj", "v_proj"):
            w = getattr(full[name], proj).weight
            assert torch.equal(getattr(part[name], proj).weight, w[16:])
        assert part[name].k_proj.bias is None
        assert torch.equal(part[name].q_proj.bias, full[name].q_proj.bias[16:])
        assert torch.equal(part[name].out_proj.weight, full[name].out_proj.weight[:, 16:])
        assert torch.equal(part[name].out_proj.bias, full[name].out_proj.bias)
    assert torch.equal(part["fc1"].weight, full["fc1"].weight[32:])
    assert torch.equal(part["fc2"].weight, full["fc2"].weight[:, 32:])
    assert torch.equal(part["fc2"].bias, full["fc2"].bias)
    with pytest.raises(ValueError, match="must divide"):
        shard_whisper_params(model, Mesh(dp=1, tp=3, dp_rank=0, tp_rank=0,
                                         device=torch.device("cpu")))
