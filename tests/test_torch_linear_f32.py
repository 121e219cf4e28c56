"""The float32 projection as 3xTF32 on the tensor cores, K6 (``ops/linear_f32.py``).

On the CPU: the wrapper is ``F.linear`` bit for bit; a plain-torch emulation
of the kernel's arithmetic (the operands split by bit masks on their int32
view, a stage's 32 k summed apart, its small terms first, and the stages
summed in float32) is within twice float32 ``F.linear``'s error against a
float64 product; the routing predicate sends the three benchmark cells'
projections to the kernel and Whisper's 2-token decoder rows and WavLM's
8-wide gate to ``F.linear``; and a forward with the counters on reports
``model.linear_kernel_flop`` / ``model.linear_plain_flop`` as its shapes
imply (all plain on the CPU).

On the card (marked ``cuda``; ``python -m pytest --noconftest
tests/test_torch_linear_f32.py -m cuda``): the kernel against cuBLAS float32
and a float64 product at every projection shape of the three cells, ragged
shapes, no bias and a tensor-parallel shard's bias-free product, its launch
counter, the weight's remainder built once, and a float32 speech forward
whose projections all take it. This file imports no JAX.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from fadtk_tpu_torch.models import base
from fadtk_tpu_torch.models import whisper_impl as wi
from fadtk_tpu_torch.models.speech import encoder as enc
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.ops import linear_f32 as k6
from fadtk_tpu_torch.runner import profiling

SMALL = dict(
    conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    num_buckets=320, max_bucket_distance=800,
)

# (rows, N, K) of every projection of the three cells, B = 16: Whisper-large
# (1500 encoder frames; the decoder's 2 tokens), WavLM-large and w2v2-base at
# the 10 s bucket (499 frames; the 60 s bucket has 2999).
ROUTED = {
    "whisper q/k/v/out, cross k/v": (24000, 1280, 1280),
    "whisper fc1": (24000, 5120, 1280), "whisper fc2": (24000, 1280, 5120),
    "wavlm feature projection": (7984, 1024, 512), "wavlm q/k/v/out": (7984, 1024, 1024),
    "wavlm intermediate": (7984, 4096, 1024), "wavlm output": (7984, 1024, 4096),
    "w2v2 feature projection": (7984, 768, 512), "w2v2 q/k/v/out": (7984, 768, 768),
    "w2v2 intermediate": (7984, 3072, 768), "w2v2 output": (7984, 768, 3072),
    "w2v2 out_proj, a tp=2 shard": (7984, 768, 384),
    "w2v2 out_proj, a tp=4 shard": (7984, 768, 192),
}
PLAIN = {
    "whisper decoder q/k/v/out": (32, 1280, 1280), "whisper decoder fc1": (32, 5120, 1280),
    "whisper decoder fc2": (32, 1280, 5120), "wavlm gate": (7984 * 16, 8, 64),
    "one clip of 10 s": (499, 768, 768), "64 wide": (47984, 64, 1024),
}


def _operands(m, k, n, bias, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device)
    w = (torch.rand((n, k), generator=g, device=device) * 2 - 1) / math.sqrt(k)
    b = torch.randn((n,), generator=g, device=device) * 0.1 if bias else None
    return x, w, b


def _errors(y, want):
    d = y.double() - want
    scale = want.abs().max().item()
    return d.abs().max().item() / scale, d.square().mean().sqrt().item() / scale


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no bias"])
def test_the_wrapper_is_f_linear_on_the_cpu(bias):
    x, w, b = _operands(3 * 37, 96, 40, bias, seed=1)
    x = x.reshape(3, 37, 96)
    lin = torch.nn.Linear(96, 40, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(w)
        if bias:
            lin.bias.copy_(b)
    launches = k6.linear_f32.launches
    assert torch.equal(k6.linear_f32(x, w, b), F.linear(x, w, b))
    assert torch.equal(base.linear(lin, x), F.linear(x, w, b))
    assert torch.equal(base.linear(lin, x, bias=False), F.linear(x, w))
    assert k6.linear_f32.launches == launches


def test_the_split_is_exact_in_tf32():
    """hi and lo carry 10 mantissa bits each and sum to v within 2^-21 of
    it; the weight's high part is its truncation, which the tensor cores
    read from the float32 bits."""
    v = torch.randn(4096, generator=torch.Generator().manual_seed(2)) * 10.0
    hi = k6.tf32_round(v)
    lo = k6.tf32_round(v - hi)
    for part in (hi, lo, k6.tf32_truncate(v), k6.weight_lo(v[None])[0]):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi.double() + lo.double() - v.double()).abs() <= v.double().abs() * 2.0 ** -21).all()
    w_hi, w_lo = k6.tf32_truncate(v), k6.weight_lo(v[None])[0]
    assert ((w_hi.double() + w_lo.double() - v.double()).abs()
            <= v.double().abs() * 2.0 ** -21).all()
    # Rounding to nearest, ties away from zero: 1 + 2^-11 (a tie) rounds up.
    assert k6.tf32_round(torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])).tolist() == [
        1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def _emulated(x, w, b, chunk=32):
    """The kernel's arithmetic in plain torch: x split in registers (rounded
    hi, rounded lo), W as its truncation and the cached remainder; each
    stage of ``chunk`` k sums its two small terms and then its large one in
    float32 (the products of two TF32 values are exact in float32), and the
    stages are summed in float32; then the bias."""
    x_hi = k6.tf32_round(x)
    x_lo = k6.tf32_round(x - x_hi)
    w_hi, w_lo = k6.tf32_truncate(w), k6.weight_lo(w)
    acc = torch.zeros((x.shape[0], w.shape[0]))
    for s in range(0, x.shape[1], chunk):
        sl = slice(s, s + chunk)
        part = x_lo[:, sl] @ w_hi[:, sl].T + x_hi[:, sl] @ w_lo[:, sl].T
        acc += part + x_hi[:, sl] @ w_hi[:, sl].T
    return acc if b is None else acc + b


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no bias"])
@pytest.mark.parametrize("k", [512, 1280])
def test_the_emulated_split_keeps_float32_accuracy(k, bias):
    x, w, b = _operands(256, k, 192, bias, seed=k)
    want = F.linear(x.double(), w.double(), None if b is None else b.double())
    got, lib = _errors(_emulated(x, w, b), want), _errors(F.linear(x, w, b), want)
    assert got[0] <= 2 * lib[0] and got[1] <= 2 * lib[1], (got, lib)
    # One TF32 product alone is some hundred times further off.
    one = _errors(F.linear(k6.tf32_round(x), k6.tf32_round(w), b), want)
    assert one[1] > 50 * lib[1], (one, lib)


class _OnCard:
    """What ``k6.takes`` reads of a contiguous float32 tensor on the card, at
    a shape no CPU test could allocate."""

    is_cuda = True
    dtype = torch.float32

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("name", list(ROUTED) + list(PLAIN))
def test_the_routing_predicate(name):
    rows, n, k = {**ROUTED, **PLAIN}[name]
    assert k6.takes(_OnCard(rows, k), _OnCard(n, k)) == (name in ROUTED)


def test_cpu_and_other_dtypes_stay_on_f_linear():
    x, w, _ = _operands(2048, 1024, 1024, False, seed=3)
    assert not k6.takes(x, w)  # the CPU
    meta = dict(device="meta")
    assert not k6.takes(torch.empty(2048, 1024, **meta), torch.empty(1024, 1024, **meta))
    assert not k6.takes(x.bfloat16(), w.bfloat16())


def _counters(monkeypatch, tmp_path, forward):
    monkeypatch.setenv(profiling.ENV, str(tmp_path))
    with torch.no_grad(), profiling.traced("test"):
        forward()
    return profiling.snapshot()["counters"]


@pytest.mark.parametrize("attention_type", ["wavlm", "standard"])
def test_a_speech_forward_counts_its_projections(attention_type, monkeypatch, tmp_path):
    """Every projection of the forward goes through ``models.base.linear``:
    the feature projection, q/k/v/out and the FFN of each layer, and WavLM's
    gate; on the CPU all of them plain."""
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "0")
    cfg = SpeechEncoderConfig(**SMALL, attention_type=attention_type)
    model = enc.init_speech_encoder(enc.SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    audio = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
    out = {}

    def forward():
        out["mask"] = enc.speech_encoder_forward(model, audio, torch.tensor([8000, 5000]))[1]

    counters = _counters(monkeypatch, tmp_path, forward)
    rows = out["mask"].numel()
    h, i = cfg.hidden_size, cfg.intermediate_size
    per_layer = 4 * h * h + 2 * h * i
    if attention_type == "wavlm":
        per_layer += cfg.num_heads * cfg.head_dim * 8
    want = 2 * rows * (cfg.conv_dim[-1] * h + cfg.num_layers * per_layer)
    assert counters["model.linear_plain_flop"] == want
    assert counters.get("model.linear_kernel_flop", 0) == 0


def test_a_whisper_forward_counts_its_projections(monkeypatch, tmp_path):
    """Whisper's encoder and decoder projections, cross-attention's k and v
    over the 1500 encoder states included, all through ``linear``."""
    cfg = wi.WhisperConfig(d_model=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
                           decoder_heads=2, encoder_ffn=64, decoder_ffn=64, vocab_size=100,
                           decoder_start_token_id=7)
    model = wi.init_whisper_params(wi.Whisper(cfg), torch.Generator().manual_seed(0))
    feats = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(1))
    counters = _counters(monkeypatch, tmp_path, lambda: wi.whisper_forward(model, feats))
    d, f, b = cfg.d_model, cfg.encoder_ffn, 2
    enc_rows, dec_rows = b * cfg.max_source_positions, b * 2
    encoder = cfg.encoder_layers * enc_rows * (4 * d * d + 2 * d * f)
    decoder = cfg.decoder_layers * (dec_rows * (6 * d * d + 2 * d * f) + enc_rows * 2 * d * d)
    assert counters["model.linear_plain_flop"] == 2 * (encoder + decoder)
    assert counters.get("model.linear_kernel_flop", 0) == 0


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = {
    **{k: (16 * 2999 if m == 7984 else m, n, kk) for k, (m, n, kk) in ROUTED.items()},
    "ragged M, K and odd N": (8021, 333, 1284), "one tile": (128, 128, 256),
    "fewer rows than a tile": (37, 200, 260),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no bias"])
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_kernel_against_cublas_and_float64_on_card(name, bias):
    """At most twice cuBLAS float32's error against a float64 product, in
    both max and RMS; one launch. The shapes at the 60 s bucket (47984 rows)
    for the speech cells; a tp shard's out_proj is bias-free, as
    ``row_sharded_linear`` calls it."""
    dev = _card()
    m, n, k = CARD_SHAPES[name]
    x, w, b = _operands(m, k, n, bias, seed=m + n + k, device=dev)
    want = F.linear(x.double(), w.double(), None if b is None else b.double())
    launches = k6.linear_f32.launches
    got = k6.linear_f32(x, w, b)
    torch.cuda.synchronize()
    assert k6.linear_f32.launches == launches + 1
    err, lib = _errors(got, want), _errors(F.linear(x, w, b), want)
    assert err[0] <= 2 * lib[0] and err[1] <= 2 * lib[1], (err, lib)


@pytest.mark.cuda
def test_the_weight_remainder_is_built_once_on_card():
    dev = _card()
    x, w, b = _operands(4096, 512, 512, True, seed=5, device=dev)
    builds = k6._weight_lo.builds
    first = k6.linear_f32(x, w, b)
    second = k6.linear_f32(x.reshape(2, 2048, 512), w, b).reshape(4096, 512)
    assert k6._weight_lo.builds == builds + 1
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_a_card_forward_routes_its_projections_to_the_kernel(monkeypatch, tmp_path):
    """A float32 WavLM forward on the card at 16 x 1 s, widths of 256 and
    more: the feature projection and each layer's six projections launch K6
    (the 8-wide gate stays plain), and its frames agree with the CPU
    forward's within 1e-4 of the largest value."""
    dev = _card()
    monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "0")
    wide = {**SMALL, "conv_dim": (256, 256, 256), "hidden_size": 256, "intermediate_size": 512}
    cfg = SpeechEncoderConfig(**wide, attention_type="wavlm")
    model = enc.init_speech_encoder(enc.SpeechEncoder(cfg), torch.Generator().manual_seed(0))
    audio = torch.randn(16, 16000, generator=torch.Generator().manual_seed(1))
    num_valid = torch.full((16,), 16000)
    num_valid[3] = 9000
    with torch.no_grad():
        want, _ = enc.speech_encoder_forward(model, audio, num_valid)
    model = model.to(dev)
    launches = k6.linear_f32.launches
    got = {}

    def forward():
        got["h"] = enc.speech_encoder_forward(model, audio.to(dev), num_valid.to(dev))[0]

    counters = _counters(monkeypatch, tmp_path, forward)
    assert k6.linear_f32.launches == launches + 1 + 6 * cfg.num_layers
    share = counters["model.linear_kernel_flop"] / (
        counters["model.linear_kernel_flop"] + counters["model.linear_plain_flop"])
    assert share > 0.9
    err = (got["h"].cpu() - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-4, err
