"""The float32 attention's fused bias and softmax (``ops/attention_softmax.py``).

On the CPU: ``_attention_core`` given WavLM's gate and table in factorized
form returns exactly what it returns given the dense bias the encoder built
before (``key_bias + gate ⊙ position_bias``, written out here), at ragged
valid lengths, for all heads and for a tensor-parallel shard's heads; a CPU
forward's attention goes through the twin, with WavLM's dense bias, and
launches nothing; and the wrapper's refusals, made before any launch (on
``meta`` tensors, which pass the same checks as CUDA ones and have no
kernel).

On the card (marked ``cuda``; ``python -m pytest --noconftest
tests/test_torch_attention_softmax.py -m cuda``): the kernel against its
plain twin at the encoders' lengths and at the longest row it takes, in
place, gated and with the key mask alone, and small float32 WavLM and w2v2
forwards with the kernel against the same forwards with the twin in its
place. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.speech import encoder as enc
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.ops import attention_softmax as asm
from fadtk_tpu_torch.runner import profiling

SMALL = dict(
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=320, max_bucket_distance=800,
)


def _attention_inputs(b, h, t, n_valid, seed, device="cpu"):
    """q, k, v (B, H, T, 16), the key mask (B, 1, 1, T) at ``n_valid``, a gate
    (B, T, H) in WavLM's range [1, 3] and a table (H, T, T)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, h, t, 16), generator=g, device=device) for _ in range(3))
    valid = torch.arange(t, device=device)[None, :] < torch.tensor(n_valid, device=device)[:, None]
    key_bias = (1.0 - valid.float())[:, None, None, :] * torch.finfo(torch.float32).min
    gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=device)
    table = torch.randn((h, t, t), generator=g, device=device)
    return q, k, v, key_bias, gate, table


@pytest.mark.parametrize("heads", ["all four", "tp shard of heads 2-3", "key mask alone"])
def test_factorized_bias_equals_the_dense_composition(heads):
    b, h, t = 3, 4, 37
    q, k, v, key_bias, gate, table = _attention_inputs(b, h, t, [37, 20, 1], seed=3)
    if heads == "tp shard of heads 2-3":
        q, k, v = (y[:, 2:] for y in (q, k, v))
        gate, table = gate[..., 2:].contiguous(), table[2:]
    with torch.no_grad():
        if heads == "key mask alone":
            got = enc._attention_core(q, k, v, key_bias)
            logits = (q * 16 ** -0.5) @ k.transpose(-1, -2) + key_bias
        else:
            got = enc._attention_core(q, k, v, key_bias, gate, table)
            dense = key_bias + gate.transpose(1, 2)[..., None] * table[None]
            assert torch.equal(enc._attention_core(q, k, v, dense), got)
            logits = (q * 16 ** -0.5) @ k.transpose(-1, -2) + dense
        want = torch.softmax(logits, dim=-1) @ v
    assert torch.equal(got, want.transpose(1, 2).reshape(b, t, -1))


@pytest.mark.parametrize("attention_type", ["wavlm", "standard"])
def test_a_cpu_forward_takes_the_twin(attention_type, monkeypatch):
    """Each plain-path attention call of a CPU forward goes through the twin,
    WavLM's with the dense bias the encoder builds there (the JAX package's
    parity path), and no kernel launches."""
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "0")
    cfg = SpeechEncoderConfig(**SMALL, attention_type=attention_type)
    model = enc.init_speech_encoder(enc.SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    audio = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
    calls = []
    real = asm.attention_softmax_reference

    def twin(logits, bias, gate=None, position_bias=None):
        calls.append((tuple(bias.shape), gate is None and position_bias is None))
        return real(logits, bias, gate, position_bias)

    monkeypatch.setattr(asm, "attention_softmax_reference", twin)
    launches = asm.attention_softmax.launches
    with torch.no_grad():
        for _ in range(2):
            _, mask = enc.speech_encoder_forward(model, audio, torch.tensor([8000, 5000]))
    b, t = mask.shape
    dense = (b, cfg.num_heads, t, t) if attention_type == "wavlm" else (b, 1, 1, t)
    assert calls == [(dense, True)] * (2 * cfg.num_layers)
    assert asm.attention_softmax.launches == launches


def _refusal_cases():
    b, h, t = 2, 3, 5
    f32 = dict(dtype=torch.float32, device="meta")
    logits = torch.zeros(b, h, t, t, **f32)
    kb, gate, table = torch.zeros(b, 1, 1, t, **f32), torch.ones(b, t, h, **f32), \
        torch.zeros(h, t, t, **f32)
    n = asm.MAX_T + 1
    return {
        "float64 logits": ((logits.double(), kb), "logits must be float32"),
        "3-d logits": ((logits[0], kb), "logits must be float32"),
        "non-square logits": ((logits[..., :4].contiguous(), kb), "logits must be float32"),
        "transposed logits": ((logits.transpose(-1, -2), kb), "must be contiguous"),
        "bf16 key mask": ((logits, kb.bfloat16()), "key_bias must be"),
        "(B, T) key mask": ((logits, kb[:, 0, 0]), "key_bias must be"),
        "head-major gate": ((logits, kb, gate.transpose(1, 2).contiguous(), table),
                            "gate must be"),
        "strided gate": ((logits, kb, torch.ones(b, h, t, **f32).transpose(1, 2), table),
                         "not contiguous"),
        "CPU key mask": ((logits, torch.zeros(b, 1, 1, t)), "key_bias must be"),
        "table of other heads": ((logits, kb, gate, table[:2]), "position_bias must be"),
        "gate without table": ((logits, kb, gate), "come together"),
        "row past MAX_T": ((torch.empty(1, 1, n, n, **f32), torch.zeros(1, 1, 1, n, **f32)),
                           "rows up to 32768"),
        "a device with no kernel": ((logits, kb, gate, table), "unsupported device meta"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_the_wrapper_refuses_before_any_launch(case):
    args, message = _refusal_cases()[case]
    launches = asm.attention_softmax.launches
    with pytest.raises(ValueError, match=message):
        asm.attention_softmax(*args)
    assert asm.attention_softmax.launches == launches


def test_the_wrapper_takes_the_twin_on_the_cpu():
    """Factorized or dense, the bias gives the same probabilities, in a new
    tensor."""
    q, k, v, key_bias, gate, table = _attention_inputs(2, 3, 11, [11, 4], seed=5)
    logits = q @ k.transpose(-1, -2)
    want = asm.attention_softmax_reference(logits, key_bias, gate, table)
    got = asm.attention_softmax(logits, key_bias, gate, table)
    assert torch.equal(got, want) and got.data_ptr() != logits.data_ptr()
    assert torch.equal(asm.attention_softmax(logits, asm.dense_gated_bias(key_bias, gate, table)),
                       want)
    assert (got[1, ..., 4:] == 0).all()


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _twin_by_rows(logits, key_bias, gate, table, rows=512):
    """The twin's probabilities, a block of query rows at a time (the twin
    holds several (B, H, rows, T) terms; whole it would not fit at T=18000)."""
    out = torch.empty_like(logits)
    t = logits.shape[-1]
    for i in range(0, t, rows):
        sl = slice(i, min(i + rows, t))
        out[:, :, sl] = asm.attention_softmax_reference(
            logits[:, :, sl], key_bias, None if gate is None else gate[:, sl],
            None if table is None else table[:, sl])
    return out


def _check_rows(got, want, n_valid, rows=512):
    """Every probability finite, each row summing to 1 within 1e-6, padded
    keys exactly 0, and within 1e-6 of the twin; a block of rows at a time."""
    err = 0.0
    for i in range(0, got.shape[-1], rows):
        g, w = got[:, :, i:i + rows], want[:, :, i:i + rows]
        assert torch.isfinite(g).all()
        assert (g.sum(dim=-1, dtype=torch.float64) - 1).abs().max().item() <= 1e-6
        for b, n in enumerate(n_valid):
            assert (g[b, ..., n:] == 0).all()
        err = max(err, (g - w).abs().max().item())
    assert err <= 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "key mask"])
@pytest.mark.parametrize("h", [8, 12, 16])
@pytest.mark.parametrize("t", [1, 499, 749, 2999, 18000])
def test_kernel_matches_twin_on_card(t, h, gated):
    dev = _card()
    b = 2 if t <= 2999 else 1
    n_valid = [t, max(1, t // 3)][:b] if b == 2 else [t - t // 5]
    g = torch.Generator(device=dev).manual_seed(t + h)
    logits = torch.randn((b, h, t, t), generator=g, device=dev).mul_(3.0)
    valid = torch.arange(t, device=dev)[None, :] < torch.tensor(n_valid, device=dev)[:, None]
    key_bias = ((1.0 - valid.float()) * torch.finfo(torch.float32).min)[:, None, None, :]
    gate = table = None
    if gated:
        gate = 1.0 + 2.0 * torch.rand((b, t, h), generator=g, device=dev)
        table = torch.randn((h, t, t), generator=g, device=dev)
    want = _twin_by_rows(logits, key_bias, gate, table)
    launches = asm.attention_softmax.launches
    got = asm.attention_softmax(logits, key_bias, gate, table)
    torch.cuda.synchronize()
    assert asm.attention_softmax.launches == launches + 1
    assert got.data_ptr() == logits.data_ptr()  # in place
    _check_rows(got, want, n_valid)


@pytest.mark.cuda
def test_the_longest_row_on_card():
    """T = MAX_T, the register form at its widest (V = 8 at 1024 threads),
    gated, with padded keys; past it the wrapper refuses (the ``meta`` case
    of the refusals above)."""
    dev = _card()
    t = asm.MAX_T
    g = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn((1, 1, t, t), generator=g, device=dev).mul_(3.0)
    key_bias = torch.zeros((1, 1, 1, t), device=dev)
    key_bias[..., t - 100:] = torch.finfo(torch.float32).min
    gate = 1.0 + 2.0 * torch.rand((1, t, 1), generator=g, device=dev)
    table = torch.randn((1, t, t), generator=g, device=dev)
    want = _twin_by_rows(logits, key_bias, gate, table)
    got = asm.attention_softmax(logits, key_bias, gate, table)
    torch.cuda.synchronize()
    _check_rows(got, want, [t - 100])


@pytest.mark.cuda
@pytest.mark.parametrize("attention_type", ["wavlm", "standard"])
def test_forward_with_the_kernel_matches_the_twin_on_card(attention_type, monkeypatch,
                                                          tmp_path):
    """A small float32 forward on the card through the kernel: one launch a
    layer, no flash kernel, no dense bias; its frames within 1e-5 of the same
    forward with the twin in the kernel's place."""
    from fadtk_tpu_torch.ops import flash_attention as fa

    dev = _card()
    cfg = SpeechEncoderConfig(**SMALL, attention_type=attention_type)
    model = enc.init_speech_encoder(enc.SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    audio = torch.randn(3, 48000, generator=torch.Generator().manual_seed(1)).to(dev)
    num_valid = torch.tensor([48000, 30000, 9000], device=dev)
    monkeypatch.setenv(profiling.ENV, str(tmp_path))
    flash = (fa.flash_attention_packed.launches, fa.flash_attention_packed.bias_launches,
             fa.flash_attention.launches, fa.flash_attention.bias_launches)
    launches = asm.attention_softmax.launches
    with torch.no_grad(), profiling.traced("test"):
        got, mask = enc.speech_encoder_forward(model, audio, num_valid)
    counters = profiling.snapshot()["counters"]
    assert asm.attention_softmax.launches == launches + cfg.num_layers
    assert counters.get("model.gated_bias_bytes", 0) == 0
    assert flash == (fa.flash_attention_packed.launches, fa.flash_attention_packed.bias_launches,
                     fa.flash_attention.launches, fa.flash_attention.bias_launches)

    monkeypatch.setattr(enc, "attention_softmax", asm.attention_softmax_reference)
    monkeypatch.delenv(profiling.ENV)
    with torch.no_grad():
        want, _ = enc.speech_encoder_forward(model, audio, num_valid)
    for i in range(audio.shape[0]):
        n = int(mask[i].sum())
        np.testing.assert_allclose(got[:, i, :n].cpu().numpy(), want[:, i, :n].cpu().numpy(),
                                   atol=1e-5, rtol=0)
