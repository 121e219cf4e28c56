"""Whisper-large's plain reference (``portbench/reference/whisper.py``)
against the port on the CPU, at a tiny Whisper-shaped size: d = 64, 4
heads, 2 encoder and 2 decoder layers, FFN 128, with the real 80 mel bins,
the real 30 s window (T = 1500 encoder frames) and the whole vocabulary,
on the benchmark's seeded weights (``portbench/families/whisper.py``),
loaded by the family's ``program_model``. Clips of 4, 30 and 45 s (padded,
exact, cut) go through the chunked spec's batched forward and through
``dataset_stats_device`` from WAV files; each clip alone through the
reference.

Tolerance 2e-5 (absolute and relative) on frames of up to ~4 after the
decoder's final LayerNorm: both sides compute in float32 and differ only in
summation order (K3's DFT as a product with its bases against
``torch.stft``, batched against one clip), measured 8.3e-7 here; the
program cast to bfloat16 misses it by ~1250 times (2.5e-2). The planted
faults below move the statistics' ``mu_err`` to 0.96-22 and ``cov_err`` to
4.1-730 against the cell's limits; the sound program reads 9.5e-7 and
2.3e-6 (through ``dataset_stats_device`` 6.0e-7 and 7.1e-7).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.dsp import mel
from fadtk_tpu_torch.models import whisper as whisper_model
from fadtk_tpu_torch.models import whisper_impl as wi
from fadtk_tpu_torch.models.whisper import WhisperModel
from fadtk_tpu_torch.ops.fused_log_mel import fused_log_mel
from fadtk_tpu_torch.runner import profiling
from fadtk_tpu_torch.runner.device_pipeline import dataset_stats_device
from portbench import compare
from portbench.families import whisper as family
from portbench.reference import audio as ref_audio
from portbench.reference import whisper as reference
from portbench.reference.gaussian import dataset_gaussian, frame_moments

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, decoder_layers=2,
            decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128,
            hidden_size=64, num_attention_heads=4, intermediate_size=128, num_hidden_layers=2)
SR = 16000
LENGTHS = (4 * SR, 30 * SR, 45 * SR)
ATOL = 2e-5


def tiny_cfg() -> dict:
    cfg = json.loads((REPO / "portbench/configs/whisper-large.json").read_text())
    cfg.update(TINY)
    return cfg


def tiny_registry_model(name):
    """The registry's whisper-large, narrowed to ``TINY``."""
    model = WhisperModel(name.split("-")[1])
    model.cfg = wi.WhisperConfig(d_model=64, encoder_layers=2, encoder_heads=4,
                                 decoder_layers=2, decoder_heads=4, encoder_ffn=128,
                                 decoder_ffn=128)
    model.num_features = 64
    return model


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The configuration, its weights, the program's model, the clips as
    16 kHz WAV files and the reference's frames of each alone."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    mp.delenv(profiling.ENV, raising=False)
    mp.setattr(family, "registry_model", tiny_registry_model)
    cfg = tiny_cfg()
    cpu = torch.device("cpu")
    w = family.make_weights(cfg, 2**31 + 19, cpu)
    model = family.program_model(cfg, w)
    d = tmp_path_factory.mktemp("whisper_clips")
    g = np.random.default_rng(5)
    files = []
    for i, n in enumerate(LENGTHS):
        pcm = np.clip(np.rint(0.3 * g.standard_normal(n) * 32768), -32768, 32767).astype("<i2")
        files.append(d / f"clip{i}.wav")
        _write_wav(files[-1], pcm)
    clips = [ref_audio.converted_clip(f, SR, cpu).float() for f in files]
    with torch.inference_mode():
        ref = [reference.forward(cfg, w, c) for c in clips]
    yield cfg, model, files, clips, ref
    mp.undo()


def _write_wav(path: Path, pcm: np.ndarray) -> None:
    import struct

    data = pcm.tobytes()
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                     + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2, 16)
                     + b"data" + struct.pack("<I", len(data)) + data)


def _windows(clips) -> torch.Tensor:
    return torch.from_numpy(np.stack([WhisperModel._make_chunk(c.numpy()) for c in clips]))


def _spec_frames(setup) -> torch.Tensor:
    _, model, _, clips, _ = setup
    with torch.inference_mode():
        return model.dp_spec().forward(_windows(clips))


def _reference_gaussian(ref):
    return dataset_gaussian(frame_moments(ref), np.ones(len(ref), np.int64))


def test_the_file_and_the_program_agree(setup):
    cfg, model, *_ = setup
    assert model.module.cfg.decoder_start_token_id == cfg["decoder_start_token_id"] == 50258
    assert model.module.cfg.max_source_positions == cfg["max_source_positions"] == 1500
    assert len(family.leaves(cfg)) + 1 == len(model.module.state_dict())


def test_the_reference_equals_the_spec_forward(setup):
    ref = setup[4]
    got = _spec_frames(setup)
    assert got.shape == (len(LENGTHS), 2, 64)
    for i, r in enumerate(ref):
        torch.testing.assert_close(got[i], r, atol=ATOL, rtol=ATOL)
    bf16 = copy.deepcopy(setup[1].module).to(torch.bfloat16)
    with torch.inference_mode():
        low = whisper_model.whisper_embed(bf16, _windows(setup[3]))
    assert (low - torch.stack(ref)).abs().max() > 50 * ATOL


def test_the_reference_equals_dataset_stats_device(setup):
    """The pipeline's (mu, cov, n) of the three files against the
    reference's Gaussian of them, within the cell's limits."""
    _, model, files, _, ref = setup
    mu, cov, n = dataset_stats_device(model, files, batch=2, workers=2)
    numbers = compare.compare_call(mu, cov, n, *_reference_gaussian(ref))
    assert n == 2 * len(LENGTHS)
    assert compare.within(numbers, compare.load_limits("whisper-large.songs")), numbers


def test_the_features_equal_the_programs(setup):
    cfg, _, _, clips, _ = setup
    got = mel.whisper_log_mel(_windows(clips))
    for i, c in enumerate(clips):
        torch.testing.assert_close(got[i], reference.log_mel(cfg, c), atol=1e-4, rtol=0)


def _cross_attention_dropped(patch, model):
    patch(wi, "_cross_attention", lambda cfg, p, x, enc_states, tp_group=None: x)


def _causal_mask_dropped(patch, model):
    real = wi._attention_core
    patch(wi, "_attention_core", lambda q, k, v, causal=False: real(q, k, v, False))


def _floor_dropped(patch, model):
    def no_floor(audio):
        re, im, bank = mel._device_bases("whisper", audio.device)
        logs = fused_log_mel(mel.whisper_frames(audio), re, im, bank, log_mode="log10_clamp")
        return ((logs + 4.0) / 4.0).transpose(1, 2)

    patch(whisper_model, "whisper_log_mel", no_floor)


def _positions_dropped(patch, model):
    enc = model.module.encoder
    patch(enc, "embed_positions", torch.nn.Parameter(torch.zeros_like(enc.embed_positions),
                                                     requires_grad=False))


FAULTS = {"sound": None, "cross-attention dropped": _cross_attention_dropped,
          "causal mask dropped": _causal_mask_dropped, "max - 8 floor dropped": _floor_dropped,
          "encoder positions dropped": _positions_dropped}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_not_correct(setup, monkeypatch, fault):
    """The spec's frames, through float16 as the pipeline folds them,
    against the reference's Gaussian under the cell's own limits
    (``portbench/limits/whisper-large.songs.json``): the sound program is
    within them, each planted fault is not."""
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch.setattr, setup[1])
    got = _spec_frames(setup)
    want = _reference_gaussian(setup[4])
    numbers = compare.compare_call(*_reference_gaussian(list(got)), *want)
    assert numbers["n_mismatch"] == 0
    limits = compare.load_limits("whisper-large.songs")
    assert compare.within(numbers, limits) is (fault == "sound"), numbers


def test_the_spans_and_counters(setup, monkeypatch, tmp_path):
    """Under ``FADTK_TPU_TRACE``, two forwards of the spec: each layer's
    spans, the decoder and the frontend once a forward, B windows a
    forward."""
    _, model, _, clips, _ = setup
    monkeypatch.setenv(profiling.ENV, str(tmp_path))
    forward = model.dp_spec().forward
    with profiling.traced("test"), torch.inference_mode():
        for _ in range(2):
            forward(_windows(clips))
    snap = profiling.snapshot()
    calls, enc, dec = snap["calls"], 2, 2
    assert calls["model.attention"] == (enc + dec) * 2
    assert calls["model.ffn"] == (enc + dec) * 2
    assert calls["model.cross_attention"] == dec * 2
    assert calls["model.frontend"] == calls["model.decoder"] == 2
    assert snap["counters"]["model.windows"] == 2 * len(LENGTHS)


def test_no_stage_opens_inside_a_wrapped_body(setup, monkeypatch):
    """The bodies the benchmark's readers wrap in a range of their own open
    no span of the program's, so that their kernels belong to that range;
    every stage of a forward opens outside them."""
    from portbench.harness import metric_reader

    targets = [t for name in ("whisper_attention_device_share", "whisper_decoder_device_share")
               for ts in metric_reader(name).RANGES.values() for t in ts]
    assert len(targets) == 4
    depth, opened = [0], []
    real_stage = profiling.stage

    def stage(name):
        opened.append((name, depth[0]))
        return real_stage(name)

    def inside(fn):
        def wrapped(*a, **k):
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return wrapped

    monkeypatch.setattr(profiling, "stage", stage)
    for t in targets:
        attr = t.split(":")[1]
        monkeypatch.setattr(wi, attr, inside(getattr(wi, attr)))
    _spec_frames(setup)
    assert len(opened) == 1 + 2 * 2 + 1 + 3 * 2  # frontend, encoder, decoder, its layers
    assert all(d == 0 for _, d in opened), opened
