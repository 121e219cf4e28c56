"""The port's VGGish (``fadtk_tpu_torch.models.vggish``) against fadtk_tpu on
the CPU.

The JAX package's random parameters (``init_vggish_params(PRNGKey(0))``,
conv kernels HWIO) are carried into the port with ``params_from_jax``
(strict), and the same numpy examples go through ``vggish_forward`` in both,
in float32 and bf16: the port runs NCHW and must flatten in the JAX
package's (h, w, c) order, or fc1 reads scrambled weights. A torch mirror of
torchvggish (tests/test_vggish.py) is the second oracle. Then the rank-4
conversion rule on its own, and the model class with random weights.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models import vggish as tv
from fadtk_tpu_torch.weights.store import params_from_jax

# Bounds relative to the largest output (random weights with zero biases
# give outputs of ~4e-3). f32: summation order only (measured 7.7e-7);
# bf16: both round every conv and GEMM output to bf16, at points XLA and
# torch's CPU kernels order differently (measured 4.0e-3, a few bf16 ulps
# through 9 layers).
RTOL_OF_MAX = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(dtype="float32"):
    import jax
    import jax.numpy as jnp

    from fadtk_tpu.models.vggish import init_vggish_params

    params = init_vggish_params(jax.random.PRNGKey(0), getattr(jnp, dtype))
    model = tv.VGGish()
    model.load_state_dict(params_from_jax(params))  # strict: one to one
    return params, model.eval().to(getattr(torch, dtype))


def _examples(seed, n=3):
    return np.random.default_rng(seed).standard_normal((n, 96, 64)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    import jax.numpy as jnp

    from fadtk_tpu.models.vggish import vggish_forward

    params, model = _pair(dtype)
    ex = _examples(1)
    want = np.asarray(vggish_forward(params, jnp.asarray(ex)))
    with torch.no_grad():
        got = tv.vggish_forward(model, torch.from_numpy(ex))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 128)
    err = np.abs(got.numpy() - want).max()
    assert err <= RTOL_OF_MAX[dtype] * np.abs(want).max(), err


def test_flatten_order_matters():
    """The (c, h, w) flatten PyTorch would take by default gives other
    embeddings: the permute is what makes the port match."""
    params, model = _pair()
    x = torch.from_numpy(_examples(2))[:, None]
    with torch.no_grad():
        for i, conv in enumerate(model.features):
            x = torch.relu(conv(x))
            if i in tv._POOL_AFTER:
                x = torch.nn.functional.max_pool2d(x, 2, 2)
        assert x.shape == (3, 512, 6, 4)
        good = model.fc1(x.permute(0, 2, 3, 1).flatten(1))
        bad = model.fc1(x.flatten(1))
    assert not torch.allclose(good, bad, atol=1e-3)


def test_forward_matches_torchvggish_mirror():
    """Against the torch mirror of torchvggish (its Sequential indices and
    its transpose/transpose/view flatten), through the JAX package's
    converter and ``params_from_jax``."""
    from torch import nn

    from fadtk_tpu.weights.vggish import convert_vggish

    layers, in_ch = [], 1
    for v in [64, "M", 128, "M", 256, 256, "M", 512, 512, "M"]:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(True)]
            in_ch = v
    torch.manual_seed(0)
    features = nn.Sequential(*layers)
    embeddings = nn.Sequential(nn.Linear(512 * 4 * 6, 4096), nn.ReLU(True),
                               nn.Linear(4096, 4096), nn.ReLU(True), nn.Linear(4096, 128))
    ex = torch.from_numpy(_examples(3))
    with torch.no_grad():
        x = features(ex[:, None]).transpose(1, 3).transpose(1, 2).contiguous()
        ref = embeddings(x.view(x.size(0), -1))
        state = {f"features.{k}": v for k, v in features.state_dict().items()}
        state.update({f"embeddings.{k}": v for k, v in embeddings.state_dict().items()})
        model = tv.VGGish()
        model.load_state_dict(params_from_jax(convert_vggish(state)))
        got = tv.vggish_forward(model.eval(), ex)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


def test_hwio_kernel_keeps_a_2d_convs_output():
    """The rank-4 rule: a JAX HWIO conv kernel becomes torch's OIHW, and
    ``F.conv2d`` then gives what ``lax.conv`` gave (SAME, NHWC)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    kernel = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    x = rng.standard_normal((2, 11, 9, 5)).astype(np.float32)  # NHWC
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    state = params_from_jax({"conv": {"kernel": kernel, "bias": bias}})
    assert state["conv.weight"].shape == (7, 5, 3, 3)
    got = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     state["conv.weight"], state["conv.bias"], padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------- #
# The model class (random weights)
# --------------------------------------------------------------------------- #


@pytest.fixture
def model(monkeypatch, tmp_path):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "none"))
    monkeypatch.delenv("FADTK_TPU_BF16", raising=False)
    from fadtk_tpu_torch.models.registry import get_model

    m = get_model("vggish")
    m.ensure_loaded()
    return m


def test_embed_path(model):
    emb = model.get_embedding(np.random.default_rng(2).standard_normal(16000 * 3) * 0.2)
    assert emb.shape == (3, 128) and emb.dtype == np.float16
    # Short audio: min_len pads to 1 s -> exactly 1 example.
    short = model.enforce_min_len(np.random.default_rng(3).standard_normal(8000) * 0.2)
    assert model.get_embedding(short).shape == (1, 128)


def test_embed_batch_matches_get_embedding(model, monkeypatch):
    """Examples of several files share forwards, across batch boundaries."""
    monkeypatch.setattr(model, "EXAMPLE_BATCH", 4)
    rng = np.random.default_rng(5)
    clips = [rng.standard_normal(int(16000 * s)) * 0.2 for s in (3.0, 0.5, 2.5, 1.0)]
    batched = model.embed_batch(clips)
    assert [b.shape[0] for b in batched] == [3, 0, 2, 1]
    for clip, got in zip(clips, batched, strict=True):
        want = model.get_embedding(clip)
        assert got.dtype == np.float16 and got.shape == want.shape
        # outputs of ~4e-3, where a float16 ulp is ~4e-6: batched CPU convs
        # may move a value by one ulp before the storage cast
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-5)
