"""The speech pipeline's processing order on the CPU, from WAV headers alone.

- ``wavio.wav_frames`` reads (frames, rate) from a RIFF/WAVE header as
  ``read_wav_int16`` counts them, for PCM, float and extensible formats, and
  None for any other file;
- ``device_pipeline.processing_order`` sorts files stably by padding bucket,
  longest first, with lengths from the convert cache's header where it
  exists, else the source's resampled to the model's rate; a list of one
  bucket keeps its order, and files no header measures go last in their
  given order. Its two counters say how often it engaged.

The WAVs here are headers whose data is a sparse hole: nothing is decoded.
"""

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from fadtk_tpu_torch.audio.wavio import read_wav_int16, wav_frames, write_wav_int16
from fadtk_tpu_torch.runner import profiling
from fadtk_tpu_torch.runner.device_pipeline import processing_order
from fadtk_tpu_torch.utils import get_convert_cache_path

SR = 8000
MODEL = SimpleNamespace(sr=SR, limit=6 * 60 * SR)  # what the order reads of a speech model


def header_wav(path: Path, frames: int, sr: int, channels: int = 1, tag: int = 1,
               bits: int = 16, extra: bytes = b"", declared: int | None = None) -> Path:
    """A WAV header for ``frames`` frames, its samples a hole in the file;
    ``extra`` chunks go between fmt and data, ``declared`` overrides the data
    chunk's size field."""
    block = channels * bits // 8
    n = frames * block
    fmt = struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)
    if tag == 0xFFFE:  # extensible: cbSize, valid bits, channel mask, sub-format GUID
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", 3) + bytes(14)
    head = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + extra
    head += b"data" + struct.pack("<I", n if declared is None else declared)
    head = b"RIFF" + struct.pack("<I", len(head) + n) + head
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(head)
        f.truncate(len(head) + n)
    return path


@pytest.mark.parametrize("channels,extra,declared", [
    (1, b"", None),
    (2, b"", None),
    (2, b"LIST" + struct.pack("<I", 3) + b"abc\0", None),  # odd chunk, word-aligned
    (1, b"", 10**9),  # the data chunk claims more than the file holds
])
def test_wav_frames_as_read_wav_int16_counts(tmp_path, channels, extra, declared):
    f = header_wav(tmp_path / "a.wav", 12345, 22050, channels, extra=extra, declared=declared)
    data, rate = read_wav_int16(f)
    assert wav_frames(f) == (data.shape[0], rate) == (12345, 22050)
    write_wav_int16(tmp_path / "b.wav", np.zeros((777, channels), np.int16).squeeze(), 16000)
    data, rate = read_wav_int16(tmp_path / "b.wav")
    assert wav_frames(tmp_path / "b.wav") == (data.shape[0], rate) == (777, 16000)


def test_wav_frames_of_float_and_extensible_and_none_otherwise(tmp_path):
    assert wav_frames(header_wav(tmp_path / "f.wav", 500, 48000, 2, tag=3, bits=32)) == (500, 48000)
    assert wav_frames(header_wav(tmp_path / "x.wav", 300, 44100, 2, tag=0xFFFE, bits=32)) == (
        300, 44100)
    (tmp_path / "s.mp3").write_bytes(b"ID3\x04" + bytes(200))
    (tmp_path / "short.wav").write_bytes(b"RIFF")
    assert wav_frames(header_wav(tmp_path / "u.wav", 100, 8000, tag=2)) is None  # ADPCM
    assert wav_frames(tmp_path / "s.mp3") is None
    assert wav_frames(tmp_path / "short.wav") is None
    assert wav_frames(tmp_path / "missing.wav") is None


def _traced_order(files):
    """processing_order under a CPU profiler: (order, its two counters)."""
    assert not profiling.refresh()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.refresh()
        order = processing_order(MODEL, files)
    c = profiling.snapshot()["counters"]
    assert not profiling.refresh()
    return order, (c["pipeline.order_probed"], c["pipeline.order_moved"])


def test_order_is_stable_by_bucket_with_unmeasured_files_last(tmp_path):
    files = [
        header_wav(tmp_path / "a.wav", 25 * SR, SR),  # 30 s bucket
        header_wav(tmp_path / "b.wav", 5 * 16000, 16000),  # 10 s at the model's rate
        tmp_path / "c.mp3",  # no header: last
        header_wav(tmp_path / "d.wav", 15 * 44100, 44100, 2),  # 20 s
        header_wav(tmp_path / "e.wav", 8 * SR, SR),  # 10 s
        tmp_path / "f.ogg",  # no header: last, after c
        header_wav(tmp_path / "g.wav", 400 * SR, SR),  # cut to the 6-minute limit
        header_wav(tmp_path / "h.wav", 25 * SR, SR),  # 30 s; its convert cache says 3 s
    ]
    (tmp_path / "c.mp3").write_bytes(b"ID3\x04" + bytes(64))
    (tmp_path / "f.ogg").write_bytes(b"OggS" + bytes(64))
    header_wav(get_convert_cache_path(SR, files[7]), 3 * SR, SR)
    order, (probed, moved) = _traced_order(files)
    assert [f.name for f in order] == ["g.wav", "a.wav", "d.wav", "b.wav", "e.wav", "h.wav",
                                       "c.mp3", "f.ogg"]
    assert (probed, moved) == (6, 7)  # only e keeps its place


def test_one_bucket_keeps_the_given_order(tmp_path):
    seconds = [7.5, 0.4, 9.9, 3.0, 10.0]  # all in the first 10 s bucket
    files = [header_wav(tmp_path / f"c{i}.wav", int(s * 44100), 44100, 2)
             for i, s in enumerate(seconds)]
    order, counters = _traced_order(files)
    assert order == files and counters == (5, 0)
