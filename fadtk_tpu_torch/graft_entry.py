"""Entry points of the port for quick checks on one or several devices.

The counterpart of the repository's ``__graft_entry__.py``:

- ``entry()``: the flagship embedding model's forward (the wav2vec2-base
  speech encoder, random weights from a seeded ``torch.Generator``) and
  example arguments: two 5 s clips, one of them ragged;
- ``dryrun_multichip(n)``: seven paths over n processes, one per device
  (gloo on the CPU, NCCL on cards): the (dp, tp) speech step, Whisper's tp
  step, the CLAP chunk dp path, encodec-emb's whole-clip dp path with ragged
  weight-0 rows, the bf16 speech step through the flash kernel K1, a tiny
  DAC chunk path and the CLI with ``--device-pipeline``. Inside a job whose
  process group is initialised (``torchrun``) they run on its ranks;
  otherwise ``n > 1`` spawns n processes on this machine
  (``torch.multiprocessing.spawn``) and ``n = 1`` runs here.

The device is ``utils.resolve_device()``'s: ``cuda`` unless
``FADTK_TPU_TORCH_DEVICE`` names another.

    python -m fadtk_tpu_torch.graft_entry [N]
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .utils import resolve_device


def _flagship(device: torch.device):
    from .models.speech.config import SpeechEncoderConfig
    from .models.speech.encoder import SpeechEncoder, init_speech_encoder

    cfg = SpeechEncoderConfig(do_normalize=False)  # w2v2-base geometry
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_speech_encoder(SpeechEncoder(cfg).to(device), gen)


def entry():
    """(fn, example_args): ``fn(*example_args)`` is the flagship forward,
    all hidden states and the frame mask."""
    from .models.speech.encoder import speech_encoder_forward

    device = resolve_device()
    _, encoder = _flagship(device)
    batch, seconds, sr = 2, 5, 16000
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((batch, seconds * sr)) * 0.1)
                             .astype(np.float32)).to(device)
    num_valid = torch.tensor([seconds * sr, seconds * sr - 1234], dtype=torch.int32,
                             device=device)
    return speech_encoder_forward, (encoder, audio, num_valid)


def _finite(*xs) -> bool:
    return all(bool(np.isfinite(np.asarray(x)).all()) for x in xs)


def _shared_dir() -> Path:
    """A scratch directory every rank of the job sees: rank 0 makes it."""
    path = [tempfile.mkdtemp(prefix="fadtk_tpu_torch_dryrun_")
            if not dist.is_initialized() or dist.get_rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(path, src=0)
    return Path(path[0])


def _paths(n_devices: int) -> None:
    """The seven paths on this rank (every rank of the job runs them)."""
    from .parallel.mesh import make_mesh
    from .parallel.tp import make_sharded_eval_step, shard_speech_params

    device = resolve_device()
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg, encoder = _flagship(device)
    # Tensor parallelism over heads / FFN columns when it divides, data
    # parallelism over clips for the rest.
    tp = 2 if (n_devices % 2 == 0 and cfg.num_heads % 2 == 0) else 1
    mesh = make_mesh(n_devices, tp=tp)
    batch, sr = mesh.dp * 2, 16000
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((batch, sr)) * 0.1).astype(np.float32)
    num_valid = rng.integers(sr // 2, sr + 1, size=batch).astype(np.int32)

    # 1. The (dp, tp) speech step.
    step = make_sharded_eval_step(cfg, encoder, mesh, layer=cfg.num_layers)
    mu, cov, n = step(shard_speech_params(encoder, mesh), audio, num_valid)
    mu, cov = mu.cpu().numpy(), cov.cpu().numpy()
    assert mu.shape == (cfg.hidden_size,) and cov.shape == (cfg.hidden_size,) * 2
    assert int(n) > 0 and _finite(mu, cov)

    # 2. Whisper's tp step (encoder + forced-token decoder), against the
    # plain forward of the same weights.
    from .models.whisper_impl import Whisper, WhisperConfig, init_whisper_params, whisper_forward
    from .parallel.whisper_tp import make_sharded_whisper_step, shard_whisper_params

    wcfg = WhisperConfig(
        d_model=32, encoder_layers=2, encoder_heads=4, decoder_layers=2,
        decoder_heads=4, encoder_ffn=64, decoder_ffn=64, num_mel_bins=16,
        max_source_positions=64, max_target_positions=8, vocab_size=64,
        decoder_start_token_id=7,
    )
    whisper = init_whisper_params(Whisper(wcfg), torch.Generator().manual_seed(2)).to(device)
    feats = torch.from_numpy((rng.standard_normal((batch, 16, 128)) * 0.3).astype(np.float32))
    emb = make_sharded_whisper_step(wcfg, mesh)(shard_whisper_params(whisper, mesh), feats)
    assert emb.shape == (batch, 2, wcfg.d_model) and _finite(emb.cpu())
    with torch.inference_mode():
        ref = whisper_forward(whisper, feats.to(device))
    assert float((emb - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))

    # 3. The CLAP chunk dp path (HTSAT-tiny, K3 in its frontend on a card):
    # 1 s clips, one 10 s chunk each, packed over dp.
    saved = os.environ.get("FADTK_TPU_RANDOM_WEIGHTS")
    os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
    try:
        from .models.clap_laion import CLAPLaionModel
        from .models.encodec import EncodecEmbModel
        from .parallel.dp import dp_chunk_dataset_stats, dp_whole_clip_dataset_stats

        clap = CLAPLaionModel("audio")
        clap.ensure_loaded()
        clips = [(rng.standard_normal(48000) * 0.1).astype(np.float32)
                 for _ in range(max(n_devices, 2))]
        cmu, ccov, cn = dp_chunk_dataset_stats(clap.dp_spec(), iter(clips), mesh)
        assert cmu.shape == (512,) and ccov.shape == (512, 512)
        assert cn == len(clips) and _finite(cmu, ccov)
        del clap

        # 4. encodec-emb's whole-clip dp path: n + 1 equal-length clips, so
        # the group pads to a multiple of dp with weight-0 rows.
        enc = EncodecEmbModel(variant="24k")
        enc.ensure_loaded()
        clips = [(rng.standard_normal(12000) * 0.1).astype(np.float32)
                 for _ in range(n_devices + 1)]
        emu, ecov, en = dp_whole_clip_dataset_stats(enc.dp_whole_spec(), iter(clips), mesh)
        assert emu.shape == (enc.num_features,) and en == len(clips) * -(-12000 // 320)
        assert _finite(emu, ecov)
        del enc
    finally:
        if saved is None:
            os.environ.pop("FADTK_TPU_RANDOM_WEIGHTS", None)
        else:
            os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = saved

    # 5. The bf16 speech step with the flash kernel forced on: K1 on a card
    # (its launch counted), the kernel's plain twin on the CPU.
    from .models.base import cast_module
    from .ops.flash_attention import flash_attention_packed

    flash = os.environ.get("FADTK_TPU_FLASH_ATTENTION")
    os.environ["FADTK_TPU_FLASH_ATTENTION"] = "1"
    try:
        bf16 = cast_module(encoder, torch.bfloat16)
        before = flash_attention_packed.launches
        bstep = make_sharded_eval_step(cfg, bf16, mesh, layer=cfg.num_layers)
        bmu, bcov, bn = bstep(shard_speech_params(bf16, mesh), audio, num_valid)
        assert bmu.shape == (cfg.hidden_size,) and int(bn) > 0
        assert _finite(bmu.cpu(), bcov.cpu())
        if device.type == "cuda":
            assert flash_attention_packed.launches - before == cfg.num_layers
    finally:
        if flash is None:
            os.environ.pop("FADTK_TPU_FLASH_ATTENTION", None)
        else:
            os.environ["FADTK_TPU_FLASH_ATTENTION"] = flash
    del encoder, bf16

    # 6. A tiny DAC (strided conv, snake) through the chunk dp path.
    from .models.dac_impl import DACEncoder, DACEncoderConfig, dac_encode, init_dac_params
    from .parallel.dp import DpChunkSpec

    dcfg = DACEncoderConfig(d_model=8, strides=(2, 2), latent_dim=32)
    dac = init_dac_params(DACEncoder(dcfg), torch.Generator().manual_seed(3)).to(device)
    win = 64
    dspec = DpChunkSpec(
        forward=lambda windows: dac_encode(dac, windows),
        make_chunks=lambda c: (np.pad(c, (0, (-len(c)) % win)).reshape(-1, 1, win)
                               .astype(np.float32),),
        num_features=dcfg.latent_dim,
        preferred_batch=2,
    )
    clips = [(rng.standard_normal(100) * 0.1).astype(np.float32) for _ in range(3)]
    dmu, dcov, dn = dp_chunk_dataset_stats(dspec, iter(clips), mesh)
    assert dmu.shape == (32,) and dn == 3 * 2 * (win // dcfg.hop_length) and _finite(dmu, dcov)

    # 7. The CLI front door: `<model> a b --device-pipeline` reaches the dp
    # engine (vggish, random weights).
    _cli_path(n_devices, rank)


def _cli_path(n_devices: int, rank: int) -> None:
    import shutil

    from .audio.wavio import float_to_int16, write_wav_int16
    from .cli.main import main as cli_main

    work = _shared_dir()
    try:
        if rank == 0:
            for name, seed in (("a", 5), ("b", 6)):
                d = work / name
                d.mkdir()
                r = np.random.default_rng(seed)
                for i in range(2):
                    t = np.arange(int(16000 * 1.1)) / 16000
                    x = 0.3 * np.sin(2 * np.pi * r.uniform(200, 1500) * t)
                    write_wav_int16(d / f"c{i}.wav", float_to_int16(x), 16000)
        if dist.is_initialized():
            dist.barrier()
        csv = work / "out.csv"
        argv, env = sys.argv, {k: os.environ.get(k) for k in
                               ("FADTK_TPU_RANDOM_WEIGHTS", "FADTK_TPU_BF16")}
        sys.argv = ["fadtk", "vggish", str(work / "a"), str(work / "b"), str(csv),
                    "--device-pipeline", "--devices", str(n_devices),
                    "--batch", str(2 * n_devices)]
        os.environ["FADTK_TPU_RANDOM_WEIGHTS"] = "1"
        os.environ.pop("FADTK_TPU_BF16", None)
        try:
            cli_main()
        finally:
            sys.argv = argv
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rank == 0:
            row = csv.read_text().splitlines()[1].split(",")
            assert row[0] == "vggish" and np.isfinite(float(row[3])), row
        if dist.is_initialized():
            dist.barrier()
    finally:
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)


def _spawned(rank: int, n_devices: int, port: int) -> None:
    """One process of a spawned job: join the group, run the paths, leave."""
    device = resolve_device()
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n_devices)
    try:
        _paths(n_devices)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the seven paths over an n-device (dp, tp) mesh; raises on any
    failed check."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a job of "
                             f"{dist.get_world_size()} processes")
        _paths(n_devices)
        return
    if n_devices == 1:
        _paths(1)
        return
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_spawned, args=(n_devices, port), nprocs=n_devices, join=True)


if __name__ == "__main__":
    fn, args = entry()
    with torch.inference_mode():
        hidden, mask = fn(*args)
    print("entry ok:", tuple(hidden.shape), tuple(mask.shape))
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
