"""The general traffic generator: a traffic mix is a data file of parameters
(``portbench/traffic/<name>.json``) that this module reads.

A mix fixes the pool of files a cell writes at set-up and the datasets the
window embeds. Keys:

- ``source_rate``, ``channels``: the files are 16-bit PCM WAV at this rate
  and channel count;
- ``pool_files``: how many distinct files the pool holds;
- ``lengths``: the clip lengths in seconds, the same set for every seed
  (only their assignment to files and their order follow the seed):
  ``{"kind": "fixed", "seconds": s}`` or
  ``{"kind": "log_uniform_grid", "min_seconds": a, "max_seconds": b}``, the
  ``pool_files`` quantiles ``a (b/a)^((i + 1/2) / pool_files)``;
- ``clips_per_call``: the files of one dataset call, a whole number of
  passes over the pool;
- ``order``: how one call orders its files; ``{"kind": "permutations"}``:
  each pass over the pool in its own seeded order;
- ``signal``: the synthetic music (tone ``amplitude``, ``harmonics``,
  fundamental range ``f0_hz``, tremolo range ``tremolo_hz``, ``noise``).

Audio is drawn from ``torch.Generator`` on the device the run uses, in
float64 phase, and quantised to int16 there; only the finished PCM goes to
the host to be written.
"""

from __future__ import annotations

import json
import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass(frozen=True)
class Traffic:
    name: str
    spec: dict

    @property
    def source_rate(self) -> int:
        return int(self.spec["source_rate"])

    @property
    def channels(self) -> int:
        return int(self.spec["channels"])

    @property
    def pool_files(self) -> int:
        return int(self.spec["pool_files"])

    @property
    def clips_per_call(self) -> int:
        return int(self.spec["clips_per_call"])


def load_traffic(name: str, directory: Path = TRAFFIC_DIR) -> Traffic:
    spec = json.loads((directory / f"{name}.json").read_text())
    t = Traffic(name, spec)
    if t.clips_per_call % t.pool_files:
        raise ValueError(f"traffic {name}: clips_per_call must be a whole number of pool passes")
    return t


def length_grid(t: Traffic) -> np.ndarray:
    """The pool's lengths in source samples, ascending: the same set on every
    seed."""
    spec = t.spec["lengths"]
    n = t.pool_files
    if spec["kind"] == "fixed":
        seconds = np.full(n, float(spec["seconds"]))
    elif spec["kind"] == "log_uniform_grid":
        a, b = float(spec["min_seconds"]), float(spec["max_seconds"])
        seconds = a * (b / a) ** ((np.arange(n) + 0.5) / n)
    else:
        raise ValueError(f"unknown lengths kind {spec['kind']!r}")
    return np.round(seconds * t.source_rate).astype(np.int64)


def pool_lengths(t: Traffic, seed: int) -> np.ndarray:
    """Length (source samples) of pool file i: the grid in a seeded order."""
    rng = np.random.default_rng([seed, 0])
    return length_grid(t)[rng.permutation(t.pool_files)]


def call_order(t: Traffic, seed: int, call: int) -> list[int]:
    """Pool indices of dataset call ``call`` (0, 1, ...), ``clips_per_call``
    long, each pool file ``clips_per_call / pool_files`` times."""
    rng = np.random.default_rng([seed, 1, call])
    n = t.pool_files
    order = t.spec["order"]
    passes = t.clips_per_call // n
    if order["kind"] == "permutations":
        return [int(i) for _ in range(passes) for i in rng.permutation(n)]
    raise ValueError(f"unknown order kind {order['kind']!r}")


def synthesize(t: Traffic, seed: int, lengths: np.ndarray, device) -> list:
    """One int16 (channels, n) tensor per pool file on ``device``: a few
    harmonics of a fundamental per clip with a tremolo, independent noise
    per channel, and a per-channel gain."""
    import torch

    sig = t.spec["signal"]
    sr = t.source_rate
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_files = len(lengths)
    f0_lo, f0_hi = sig["f0_hz"]
    tr_lo, tr_hi = sig["tremolo_hz"]
    u = torch.rand((n_files, 4 + t.channels), generator=g, device=device, dtype=torch.float64)
    f0 = f0_lo * (f0_hi / f0_lo) ** u[:, 0]
    tremolo = tr_lo + (tr_hi - tr_lo) * u[:, 1]
    phase = 2 * math.pi * u[:, 2]
    gains = 0.8 + 0.2 * u[:, 4:]
    h = torch.arange(1, int(sig["harmonics"]) + 1, device=device, dtype=torch.float64)
    weights = 1.0 / h
    weights = weights / weights.sum()
    out = []
    for i, n in enumerate(lengths.tolist()):
        tt = torch.arange(n, device=device, dtype=torch.float64) / sr
        tone = (torch.sin(2 * math.pi * f0[i] * tt[:, None] * h[None, :] + phase[i]) * weights).sum(1)
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * tremolo[i] * tt)
        clean = (sig["amplitude"] * tone * env).float()
        noise = torch.randn((t.channels, n), generator=g, device=device) * float(sig["noise"])
        x = (clean[None, :] + noise) * gains[i, :, None].float()
        out.append(torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16))
    return out


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """A canonical 44-byte-header PCM WAV of int16 ``pcm`` (channels, n)."""
    channels = pcm.shape[0]
    payload = np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr, sr * channels * 2,
                                    channels * 2, 16)
    header += b"data" + struct.pack("<I", len(payload))
    return header + payload


def write_pool(t: Traffic, seed: int, root: Path, device) -> tuple[list[Path], np.ndarray]:
    """Write the pool into ``root`` (no ``convert/`` beside it, so every read
    takes the loader's miss path); returns the files and their lengths in
    source samples."""
    lengths = pool_lengths(t, seed)
    root.mkdir(parents=True, exist_ok=True)
    files = []
    for i, pcm in enumerate(synthesize(t, seed, lengths, device)):
        f = root / f"clip{i:04d}.wav"
        f.write_bytes(wav_bytes(pcm.cpu().numpy(), t.source_rate))
        files.append(f)
    return files, lengths
