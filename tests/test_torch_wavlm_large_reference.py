"""WavLM-large's plain reference (``portbench/reference/wavlm_encoder.py``)
against the port on the CPU, at a tiny WavLM-large-shaped size: pre-norm
layers, a layer-norm extractor with conv bias, input normalisation, seven
convs of width 16 with the published kernels and strides, hidden 64, 4
heads, 2 layers, 320 buckets out to 800 frames, on the benchmark's seeded
weights (``portbench/families/wavlm.py``). A ragged batch of clips of 10,
4.4 and 3 s, zero-padded to one 10 s bucket (499, 218 and 149 frames, so
that key offsets pass 80 and reach the log-spaced buckets), goes through
``speech_encoder_forward`` and the tensor-parallel forward (tp = 1); each
clip alone through the reference.

Tolerance 2e-5 (absolute and relative) on hidden states of up to ~3.5
after the final LayerNorm: both sides compute in float32 and differ only in
summation order (batched and padded against one clip), measured 6.1e-6
here. The planted faults below move the statistics' ``mu_err`` by 6e-3 to
1.1 and ``cov_err`` by 2.5e-2 to 0.7, the sound program 2.6e-6 and 5.3e-6.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.models.speech import encoder as enc
from fadtk_tpu_torch.models.speech.config import SpeechEncoderConfig
from fadtk_tpu_torch.parallel import tp
from fadtk_tpu_torch.parallel.mesh import make_mesh
from fadtk_tpu_torch.runner import profiling
from portbench import compare
from portbench.families import speech, wavlm
from portbench.reference import wavlm_encoder
from portbench.reference.gaussian import dataset_gaussian, frame_moments

REPO = Path(__file__).resolve().parents[1]
TINY = dict(conv_dim=[16] * 7, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            layer=2)
SR = 16000
BUCKET = 10 * SR
LENGTHS = (BUCKET, 70000, 48000)
ATOL = 2e-5


def tiny_cfg() -> dict:
    cfg = json.loads((REPO / "portbench/configs/wavlm-large.json").read_text())
    cfg.update(TINY)
    return cfg


def program_cfg(cfg: dict) -> SpeechEncoderConfig:
    fields = {f: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
              for k, f in speech._PROGRAM_FIELDS.items()}
    return SpeechEncoderConfig(**fields, num_buckets=cfg["num_buckets"],
                               max_bucket_distance=cfg["max_bucket_distance"])


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv(profiling.ENV, raising=False)
    enc._bucket_index.cache_clear()  # a planted bucket fault must not outlive its test
    yield
    enc._bucket_index.cache_clear()


@pytest.fixture(scope="module")
def setup():
    """The tiny configuration, its weights and module, the padded batch and
    the reference's frames of each clip alone."""
    cfg = tiny_cfg()
    w = wavlm.make_weights(cfg, 2**31 + 19, torch.device("cpu"))
    module = enc.SpeechEncoder(program_cfg(cfg))
    module.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(5)
    audio = torch.zeros(len(LENGTHS), BUCKET)
    for i, n in enumerate(LENGTHS):
        audio[i, :n] = 0.3 * torch.randn(n, generator=g)
    num_valid = torch.tensor(LENGTHS, dtype=torch.int32)
    with torch.inference_mode():
        ref = [wavlm_encoder.forward(cfg, w, audio[i, :n], cfg["layer"])
               for i, n in enumerate(LENGTHS)]
    return cfg, module, audio, num_valid, ref


def _forward_frames(setup, path):
    cfg, module, audio, num_valid, _ = setup
    with torch.inference_mode():
        if path == "speech_encoder_forward":
            states, mask = enc.speech_encoder_forward(module, audio, num_valid, taps=(2,))
            states = states[0]
        else:
            states, mask = tp._tp_forward(module.cfg, module, audio, num_valid, make_mesh(), 2)
    return states, mask


@pytest.mark.parametrize("path", ["speech_encoder_forward", "tp_forward"])
def test_the_reference_equals_the_program(setup, path):
    states, mask = _forward_frames(setup, path)
    ref = setup[4]
    assert [int(m.sum()) for m in mask] == [r.shape[0] for r in ref] == [499, 218, 149]
    for i, r in enumerate(ref):
        torch.testing.assert_close(states[i, :r.shape[0]], r, atol=ATOL, rtol=ATOL)


# key offset s - t -> bucket, from the published T5 formula with 320 buckets
# and distance 800: 160 a side, the first 80 distances exact, then
# 80 + floor(80 ln(d / 80) / ln 10) up to 159; keys after the query add 160.
HAND = {0: 0, 1: 161, -1: 1, 79: 239, -79: 79, 80: 240, -80: 80, 81: 240, -81: 80,
        400: 295, -400: 135, 799: 319, -799: 159, 1000: 319, -1000: 159}


@pytest.mark.parametrize("side", ["reference", "program"])
def test_the_buckets_by_hand(side):
    t, q = 2001, 1000
    if side == "reference":
        table = wavlm_encoder.relative_buckets(320, 800, t).numpy()
    else:
        table = enc._wavlm_relative_buckets(320, 800, t)
    assert {off: int(table[q, q + off]) for off in HAND} == HAND


def _gate_held_at_one(patch, module):
    real = enc.wavlm_gated_bias

    def planted(cfg, p, x, position_bias, key_bias, **kw):
        gate, _ = real(cfg, p, x, position_bias, key_bias, **kw)
        return torch.ones_like(gate), key_bias + position_bias[None]

    patch(enc, "wavlm_gated_bias", planted)


def _bias_dropped(patch, module):
    real = enc.wavlm_gated_bias
    patch(enc, "wavlm_gated_bias",
          lambda cfg, p, x, position_bias, key_bias, **kw:
          (real(cfg, p, x, position_bias, key_bias, **kw)[0], key_bias))


def _buckets_shifted(patch, module):
    real = enc._wavlm_relative_buckets
    patch(enc, "_wavlm_relative_buckets", lambda n, d, t: np.minimum(real(n, d, t) + 1, n - 1))


def _final_norm_skipped(patch, module):
    real, final = enc._layer_norm, module.encoder["layer_norm"]
    patch(enc, "_layer_norm", lambda x, ln, eps: x if ln is final else real(x, ln, eps))


FAULTS = {"sound": None, "gate held at 1": _gate_held_at_one, "bias dropped": _bias_dropped,
          "buckets shifted by one": _buckets_shifted,
          "final LayerNorm skipped": _final_norm_skipped}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_not_correct(setup, monkeypatch, fault):
    """The tp step's (mu, cov, n) of the batch against the reference's
    Gaussian of the three clips, under the cell's own limits
    (``portbench/limits/wavlm-large.songs.json``): the sound program is
    within them, each planted fault is not."""
    cfg, module, audio, num_valid, ref = setup
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch.setattr, module)
    step = tp.make_sharded_eval_step(module.cfg, module, make_mesh(), cfg["layer"])
    mu, cov, n = step(module, audio, num_valid)
    want = dataset_gaussian(frame_moments(ref), np.ones(len(ref), np.int64))
    numbers = compare.compare_call(mu.double().numpy(), cov.double().numpy(), int(n), *want)
    assert numbers["n_mismatch"] == 0
    limits = compare.load_limits("wavlm-large.songs")
    assert compare.within(numbers, limits) is (fault == "sound"), numbers


@pytest.mark.parametrize("case", ["float32 dense", "bfloat16 flash", "w2v2"])
def test_the_gated_bias_counters(setup, monkeypatch, tmp_path, case):
    """Under ``FADTK_TPU_TRACE``, one step of the batch: the dense bias's
    bytes are layers x B x H x T^2 x 4 in float32, none where the flash
    kernel (its twin here) takes the gate, none for w2v2; the (H, T, T)
    table is built once a forward."""
    cfg, module, audio, num_valid, _ = setup
    layers, b, h, t = 2, len(LENGTHS), 4, 499
    if case == "bfloat16 flash":
        monkeypatch.setenv("FADTK_TPU_FLASH_ATTENTION", "1")
        module = enc.SpeechEncoder(module.cfg).to(torch.bfloat16)
    elif case == "w2v2":
        module = enc.SpeechEncoder(SpeechEncoderConfig(**{
            **module.cfg.__dict__, "attention_type": "standard"}))
    monkeypatch.setenv(profiling.ENV, str(tmp_path))
    step = tp.make_sharded_eval_step(module.cfg, module, make_mesh(), cfg["layer"])
    with profiling.traced("test"):
        step(module, audio, num_valid)
    snap = profiling.snapshot()
    built = snap["counters"].get("model.gated_bias_bytes", 0)
    table = snap["counters"].get("model.position_bias_bytes", 0)
    if case == "w2v2":
        assert built == table == 0 and "model.gated_bias" not in snap["seconds"]
        return
    assert snap["calls"]["model.gated_bias"] == layers
    assert table == h * t * t * (2 if case == "bfloat16 flash" else 4)
    assert built == (layers * b * h * t * t * 4 if case == "float32 dense" else 0)
