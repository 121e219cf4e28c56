"""The port's weight converters (``fadtk_tpu_torch/weights/``) against the JAX
package's, on the CPU.

- For every family the same seeded state dict goes through the JAX
  package's ``convert_cli.convert_model`` and the port's, each into its own
  ``FADTK_TPU_CHECKPOINTS``, and the two ``.npz`` files must be equal key for
  key, dtype for dtype and bit for bit (``__config__`` included). The state
  dicts come from the recorded schemas (``weights/schemas.py``: DAC, the
  laion_clap .pt and msclap .pth trees, VGGish), a small CDPAM encoder, and,
  for the HF families (w2v2, HuBERT, WavLM, Whisper, EnCodec, CLAP), tiny
  random ``transformers`` models served by a patched ``from_pretrained``;
- the dry-run catches a missing key, a dropped key and a shape mismatch (the
  counterparts of tests/test_convert_dryrun.py), passes every recorded
  schema, leaves ``FADTK_TPU_RANDOM_WEIGHTS`` as it was, and imports no jax
  when run as ``python -m fadtk_tpu_torch.weights.convert_cli``;
- ``--dump-schema`` writes the JAX package's JSON format;
- a converted ``.npz`` loads into the port's module with ``strict=True`` and
  through the model's own ``load_model``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fadtk_tpu_torch.weights import dryrun, schemas
from fadtk_tpu_torch.weights.store import load_params, params_from_jax

REPO = Path(__file__).resolve().parents[1]


def _random_state(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(np.asarray(rng.standard_normal(s) * 0.1, np.float32))
            for k, s in shapes.items()}


def _save_ckpt(path: Path, sd: dict, wrap: str | None = None) -> str:
    torch.save({wrap: sd} if wrap else sd, path)
    return str(path)


def _convert_both(monkeypatch, tmp_path, name, checkpoint=None) -> Path:
    """Both packages' convert_model into two checkpoint dirs; asserts the
    written files are equal bit for bit and returns the port's dir."""
    from fadtk_tpu.weights import convert_cli as jax_cli

    from fadtk_tpu_torch.weights import convert_cli as port_cli

    for pkg, cli in (("jax", jax_cli), ("torch", port_cli)):
        monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / pkg))
        cli.convert_model(name, checkpoint=checkpoint)
    _assert_same_npz(tmp_path / "jax", tmp_path / "torch")
    return tmp_path / "torch"


def _assert_same_npz(a: Path, b: Path) -> None:
    files = sorted(p.name for p in a.glob("*.npz"))
    assert files and files == sorted(p.name for p in b.glob("*.npz"))
    for f in files:
        with np.load(a / f) as x, np.load(b / f) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
                assert x[k].tobytes() == y[k].tobytes(), k


# --------------------------------------------------------------------------- #
# The checkpoint-file families
# --------------------------------------------------------------------------- #


def test_dac_matches_jax_and_loads(monkeypatch, tmp_path):
    from fadtk_tpu_torch.models.dac_impl import DAC_44K, DACEncoder

    sd = _random_state(schemas.dac_44khz_encoder_schema(), 0)
    out = _convert_both(monkeypatch, tmp_path, "dac-44kHz",
                        _save_ckpt(tmp_path / "weights_44khz.pth", sd, "state_dict"))
    module = DACEncoder(DAC_44K)
    module.load_state_dict(params_from_jax(load_params(out / "dac_44khz.npz"), "OIH"),
                           strict=True)


@pytest.mark.parametrize("name,amodel", [("clap-laion-audio", "HTSAT-tiny"),
                                         ("clap-laion-music", "HTSAT-base")])
def test_laion_pt_matches_jax_and_loads(monkeypatch, tmp_path, name, amodel):
    from fadtk_tpu_torch.models.registry import get_model

    sd = _random_state(schemas.laion_clap_pt_schema(amodel), 1)
    _convert_both(monkeypatch, tmp_path, name, _save_ckpt(tmp_path / "ck.pt", sd, "state_dict"))
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    model = get_model(name)
    model.load_model()  # load_state_dict, strict
    want = sd["module.audio_projection.0.weight"]
    assert torch.equal(model.module.audio_projection.linear1.weight, want)


def test_msclap_matches_jax_and_loads(monkeypatch, tmp_path):
    from fadtk_tpu_torch.models.registry import get_model

    sd = _random_state(schemas.msclap_2023_audio_schema(), 2)
    _convert_both(monkeypatch, tmp_path, "clap-2023",
                  _save_ckpt(tmp_path / "CLAP_weights_2023.pth", sd, "model"))
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    model = get_model("clap-2023")
    model.load_model()
    assert torch.equal(model.module.projection.linear2.weight,
                       sd["audio_encoder.projection.linear2.weight"])


class _CdpamEnc(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = torch.nn.ModuleList(
            [torch.nn.Conv1d(1, 8, 3, 2, 1), torch.nn.Conv1d(8, 16, 3, 2, 1)])
        self.norms = torch.nn.ModuleList([torch.nn.BatchNorm1d(8), torch.nn.BatchNorm1d(16)])
        self.fc_acoustic = torch.nn.Linear(16, 12)
        self.fc_content = torch.nn.Linear(16, 12)


def _cdpam_state() -> dict:
    torch.manual_seed(3)
    enc = _CdpamEnc()
    for bn in enc.norms:
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2.0)
    return {f"base_encoder.{k}": v for k, v in enc.state_dict().items()}


def test_cdpam_matches_jax_and_loads(monkeypatch, tmp_path):
    from fadtk_tpu_torch.models.registry import get_model

    sd = _cdpam_state()
    _convert_both(monkeypatch, tmp_path, "cdpam-acoustic",
                  _save_ckpt(tmp_path / "scratch_loss.pth", sd, "state"))
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    model = get_model("cdpam-content")
    model.load_model()  # the inferred geometry from __config__
    assert model.cfg.channels == (8, 16) and model.cfg.emb_dim == 12
    assert torch.equal(model.module.content.weight, sd["base_encoder.fc_content.weight"])


def test_vggish_matches_jax_and_loads(monkeypatch, tmp_path):
    """The JAX package converts VGGish from torch.hub only; the port also
    takes the hub's state-dict file. Both trees, saved, are the same file."""
    from fadtk_tpu.weights.store import save_params as jax_save
    from fadtk_tpu.weights.vggish import convert_vggish as jax_convert

    from fadtk_tpu_torch.models.vggish import VGGish

    sd = _random_state(schemas.vggish_schema(), 4)
    jax_save(jax_convert(sd), tmp_path / "jax" / "vggish.npz")
    monkeypatch.setenv("FADTK_TPU_CHECKPOINTS", str(tmp_path / "torch"))
    from fadtk_tpu_torch.weights import convert_cli

    convert_cli.convert_model("vggish", checkpoint=_save_ckpt(tmp_path / "vggish.pth", sd))
    _assert_same_npz(tmp_path / "jax", tmp_path / "torch")
    VGGish().load_state_dict(params_from_jax(load_params(tmp_path / "torch" / "vggish.npz")),
                             strict=True)


# --------------------------------------------------------------------------- #
# The HF families: tiny random transformers models behind from_pretrained
# --------------------------------------------------------------------------- #


def _serve(monkeypatch, cls, model):
    monkeypatch.setattr(cls, "from_pretrained", classmethod(lambda c, *a, **k: model))


def _no_processor(monkeypatch):
    import transformers

    def fail(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(transformers.Wav2Vec2FeatureExtractor, "from_pretrained", fail)


SPEECH = {
    "w2v2-base": ("Wav2Vec2Model", "Wav2Vec2Config", {}),
    "hubert-base": ("HubertModel", "HubertConfig", {}),
    "wavlm-base-plus": ("WavLMModel", "WavLMConfig", {"num_buckets": 16,
                                                       "max_bucket_distance": 40}),
}


@pytest.mark.parametrize("name", list(SPEECH))
def test_speech_matches_jax_and_loads(monkeypatch, tmp_path, name):
    import transformers

    from fadtk_tpu_torch.models.registry import get_model

    model_cls, cfg_cls, extra = SPEECH[name]
    torch.manual_seed(5)
    cfg = getattr(transformers, cfg_cls)(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2), conv_bias=True,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, **extra)
    hf = getattr(transformers, model_cls)(cfg).eval()
    _serve(monkeypatch, getattr(transformers, model_cls), hf)
    _no_processor(monkeypatch)
    out = _convert_both(monkeypatch, tmp_path, name)
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    model = get_model(name)
    model.load_model()  # the stored __config__ replaces the geometry
    assert (out / f"{model.weights_name()}.npz").exists()
    assert model.cfg.hidden_size == 32 and model.cfg.conv_dim == (8, 8)


def test_whisper_matches_jax_and_loads(monkeypatch, tmp_path):
    import transformers

    from fadtk_tpu_torch.models.registry import get_model

    torch.manual_seed(6)
    cfg = transformers.WhisperConfig(
        d_model=32, encoder_layers=2, encoder_attention_heads=4, decoder_layers=2,
        decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
        max_source_positions=1500, max_target_positions=16, vocab_size=100,
        decoder_start_token_id=7, pad_token_id=0, bos_token_id=1, eos_token_id=2)
    hf = transformers.WhisperModel(cfg).eval()
    _serve(monkeypatch, transformers.WhisperModel, hf)
    _convert_both(monkeypatch, tmp_path, "whisper-tiny")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    model = get_model("whisper-tiny")
    model.load_model()
    assert model.cfg.d_model == 32 and model.cfg.vocab_size == 100


def test_encodec_matches_jax_and_loads(monkeypatch, tmp_path):
    import transformers

    from fadtk_tpu_torch.models.registry import get_model

    torch.manual_seed(7)
    hf = transformers.EncodecModel(transformers.EncodecConfig()).eval()  # the 24 kHz tree
    _serve(monkeypatch, transformers.EncodecModel, hf)
    _convert_both(monkeypatch, tmp_path, "encodec-emb")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    get_model("encodec-emb").load_model()


def test_hf_clap_matches_jax_and_loads(monkeypatch, tmp_path):
    """The HF ClapModel tree (HTSAT-tiny audio tower, a narrow text tower)."""
    import transformers

    from fadtk_tpu_torch.models.registry import get_model

    torch.manual_seed(8)
    cfg = transformers.ClapConfig(text_config=dict(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=37,
        vocab_size=100, max_position_embeddings=64))
    hf = transformers.ClapModel(cfg).eval()
    _serve(monkeypatch, transformers.ClapModel, hf)
    _convert_both(monkeypatch, tmp_path, "clap-laion-audio")
    monkeypatch.setenv("FADTK_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    get_model("clap-laion-audio").load_model()


# --------------------------------------------------------------------------- #
# The dry-run and --dump-schema
# --------------------------------------------------------------------------- #


def _dac_dry_run(schema, reference=True):
    from fadtk_tpu_torch.models.dac_impl import DAC_44K, DACEncoder
    from fadtk_tpu_torch.weights.dac import convert_dac_encoder

    return dryrun.dry_run_convert(
        "dac-44kHz", schema, lambda sd: convert_dac_encoder(sd, DAC_44K),
        relevant=lambda k: k.startswith("encoder."),
        reference=(lambda _: DACEncoder(DAC_44K)) if reference else None,
        conv_layout="OIH")


def test_dryrun_passes_the_published_dac_inventory():
    schema = schemas.dac_44khz_encoder_schema()
    assert len([k for k in schema if k.startswith("encoder.")]) == 119
    _dac_dry_run(schema)


def test_dryrun_detects_missing_key():
    schema = schemas.dac_44khz_encoder_schema()
    del schema["encoder.block.0.weight_g"]
    with pytest.raises(ValueError, match="requested a key absent"):
        _dac_dry_run(schema, reference=False)


def test_dryrun_detects_dropped_key():
    schema = schemas.dac_44khz_encoder_schema()
    schema["encoder.block.7.weight_g"] = (64, 1, 1)  # a layer the converter doesn't map
    with pytest.raises(ValueError, match="never read"):
        _dac_dry_run(schema, reference=False)


def test_dryrun_detects_shape_mismatch():
    schema = schemas.dac_44khz_encoder_schema()
    # Internally consistent but the wrong output width: the conversion
    # succeeds, the comparison with the port's module must catch it.
    schema["encoder.block.6.weight_g"] = (512, 1, 1)
    schema["encoder.block.6.weight_v"] = (512, 1024, 3)
    schema["encoder.block.6.bias"] = (512,)
    with pytest.raises(ValueError, match="disagrees with the model's module"):
        _dac_dry_run(schema)


def _write_schema(path: Path, schema: dict) -> str:
    path.write_text(json.dumps({k: list(v) for k, v in schema.items()}))
    return str(path)


RECORDED = {
    "dac-44kHz": lambda: schemas.dac_44khz_encoder_schema(),
    "clap-laion-audio": lambda: schemas.laion_clap_pt_schema("HTSAT-tiny"),
    "clap-laion-music": lambda: schemas.laion_clap_pt_schema("HTSAT-base"),
    "clap-2023": lambda: schemas.msclap_2023_audio_schema(),
    "cdpam-acoustic": lambda: schemas.cdpam_base_encoder_schema(),
    "vggish": lambda: schemas.vggish_schema(),
}


def test_dryrun_model_passes_every_recorded_schema(tmp_path, monkeypatch):
    monkeypatch.delenv("FADTK_TPU_RANDOM_WEIGHTS", raising=False)
    for name, make in RECORDED.items():
        dryrun.dry_run_model(name, _write_schema(tmp_path / f"{name}.json", make()))
    assert "FADTK_TPU_RANDOM_WEIGHTS" not in os.environ
    monkeypatch.setenv("FADTK_TPU_RANDOM_WEIGHTS", "0")
    dryrun.dry_run_model("clap-2023", str(tmp_path / "clap-2023.json"))
    assert os.environ["FADTK_TPU_RANDOM_WEIGHTS"] == "0"


def test_cdpam_dryrun_matches_jax(tmp_path):
    """The small CDPAM encoder's inventory through both packages' dry-run."""
    from fadtk_tpu.weights.dryrun import dry_run_model as jax_dry_run

    path = _write_schema(tmp_path / "cdpam.json",
                         {k: tuple(v.shape) for k, v in _cdpam_state().items()})
    jax_dry_run("cdpam-acoustic", path)
    dryrun.dry_run_model("cdpam-acoustic", path)


def test_dump_schema_format_matches_jax(tmp_path):
    from fadtk_tpu.weights.dryrun import dump_schema as jax_dump

    ck = _save_ckpt(tmp_path / "ck.pth", {"encoder.w": torch.zeros(3, 4),
                                          "encoder.b": torch.zeros(4), "step": 3}, "state_dict")
    jax_dump(ck, tmp_path / "jax.json")
    dryrun.dump_schema(ck, str(tmp_path / "torch.json"))
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    assert dryrun.load_schema(tmp_path / "torch.json") == {"encoder.w": (3, 4),
                                                          "encoder.b": (4,)}


def test_convert_cli_dry_run_imports_no_jax(tmp_path):
    """``--dump-schema`` then ``--dry-run`` through the module's CLI, in a
    process that must not import jax (nor need transformers)."""
    sd = _random_state(schemas.dac_44khz_encoder_schema(), 9)
    ck = _save_ckpt(tmp_path / "weights_44khz.pth", sd, "state_dict")
    env = {**os.environ, "PYTHONPATH": str(REPO), "FADTK_TPU_TORCH_DEVICE": "cpu"}
    check = ("import runpy, sys; sys.argv = ['convert_cli', *sys.argv[1:]]; "
             "runpy.run_module('fadtk_tpu_torch.weights.convert_cli', run_name='__main__'); "
             "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
             "'transformers', 'fadtk_tpu.'))]; assert not bad, bad")
    for argv in (["--dump-schema", ck, str(tmp_path / "dac.json")],
                 ["dac-44kHz", "--dry-run", str(tmp_path / "dac.json")]):
        p = subprocess.run([sys.executable, "-c", check, *argv], env=env, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    assert "dry-run OK" in p.stderr and "matches the model's module" in p.stderr
