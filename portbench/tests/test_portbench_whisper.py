"""The Whisper cell's files: the family's FLOPs a window against a count by
hand, the configuration's widths against the program's ``whisper-large``,
the manifest's new entries, and the three readers' ranges."""

import json
from types import SimpleNamespace

import pytest

from portbench import harness, manifest
from portbench.families import whisper as family

CFG = manifest.config(manifest.load(), "whisper-large")
READERS = ("whisper_attention_device_share", "whisper_decoder_device_share")


def test_clip_flops_by_hand():
    """d = 1280, T = 1500, FFN 5120, 32 + 32 layers, 2 tokens, 2 FLOP a
    multiply-add."""
    conv = 2 * 3000 * 1280 * 80 * 3 + 2 * 1500 * 1280 * 1280 * 3  # 1.6580e10
    enc_layer = 2 * 1500 * 1280 * 1280 * 4 + 2 * 1500 * 1280 * 5120 * 2 \
        + 2 * 1500 * 1500 * 1280 * 2  # 7.0502e10
    cross_kv = 2 * 1500 * 1280 * 1280 * 2  # 9.8304e9
    dec_rest = 2 * 2 * 1280 * 1280 * 4 + 2 * 2 * 2 * 1280 * 2 + 2 * 2 * 1280 * 1280 * 2 \
        + 2 * 2 * 1500 * 1280 * 2 + 2 * 2 * 1280 * 5120 * 2
    total = conv + 32 * enc_layer + 32 * (cross_kv + dec_rest)
    assert family.clip_flops(CFG, 16000) == family.clip_flops(CFG, 10**7) == total
    assert total == pytest.approx(2.5907e12, rel=1e-4)


def test_the_widths_are_the_programs():
    from fadtk_tpu_torch.models.whisper_impl import config_for_size

    program = config_for_size("large")
    for key, field in family._PROGRAM_FIELDS.items():
        assert CFG[key] == getattr(program, field), key
    assert (CFG["hidden_size"], CFG["num_attention_heads"], CFG["intermediate_size"],
            CFG["num_hidden_layers"]) == (1280, 20, 5120, 32)
    assert CFG["reduced"] == [] and CFG["batch_per_card"] == 16 and CFG["precision"] == "float32"
    assert CFG["decoder_start_token_id"] == 50258 != program.decoder_start_token_id


def test_the_manifest_holds_the_cell():
    m = manifest.load()
    assert manifest.problems(m) == []
    cell = manifest.cell(m, "whisper-large.songs")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("whisper-large", "songs", 1)
    e2e, layer = manifest.cell_metrics(m, "whisper-large.songs")
    assert {x["name"] for x in e2e} == {"embed_audio_s_per_s", "setup_s"}
    assert {x["name"] for x in layer} == {"whisper_mfu", *READERS}
    assert family.batch_shape(CFG, None) == 480000


@pytest.mark.parametrize("name", READERS)
def test_the_ranges_name_functions_of_the_program(name):
    import importlib

    ranges = harness.metric_reader(name).RANGES
    targets = [t for ts in ranges.values() for t in ts]
    assert targets
    for t in targets:
        module, attr = t.split(":")
        assert callable(getattr(importlib.import_module(module), attr))


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_bodies_reads_nothing(name, monkeypatch):
    """The parent program has none of the bodies: no range, no reading."""
    from fadtk_tpu_torch.models import whisper_impl

    mod = harness.metric_reader(name)
    for attr in mod.BODIES:
        monkeypatch.delattr(whisper_impl, attr)
    again = harness.metric_reader(name)
    assert all(not ts for ts in again.RANGES.values())
    trace = {"kernel_s": 1.0, "ranges": {}, "kernels": {"k": 1.0}}
    assert again.read(SimpleNamespace(record=SimpleNamespace(trace=trace))) is None


def test_whisper_mfu_is_the_mfu_reader():
    rec = SimpleNamespace(calls=[{"flops": 4.95e14}], window_s=2.0, chips=1, precision="float32")
    ctx = SimpleNamespace(record=rec)
    assert harness.metric_reader("whisper_mfu").read(ctx) == pytest.approx(0.5)
    assert json.loads(json.dumps(CFG))["family"] == "whisper"
