"""Convert upstream torch checkpoints to the weight files both packages read.

The port of ``fadtk_tpu/weights/convert_cli.py`` (``fadtk-convert``), run as

    python -m fadtk_tpu_torch.weights.convert_cli <model> [--checkpoint FILE]
    python -m fadtk_tpu_torch.weights.convert_cli --all-speech
    python -m fadtk_tpu_torch.weights.convert_cli <model> --dry-run schema.json
    python -m fadtk_tpu_torch.weights.convert_cli --dump-schema ck.pth schema.json

It writes the same flat ``.npz`` as the JAX package's converters — the same
keys, dtypes, values and ``__config__`` metadata — into
``weights/store.py::params_path`` (``FADTK_TPU_CHECKPOINTS``), so one
conversion serves both packages. It needs torch and numpy only: the
configs are the port's own classes, and ``transformers`` is imported inside
the branches that read HF trees (the speech family, Whisper, EnCodec, and
CLAP-LAION without ``--checkpoint``). The ``.pt`` / ``.pth`` branches
(clap-laion-* and clap-2023, dac-44kHz, cdpam-*, vggish with
``--checkpoint``), ``--dry-run`` and ``--dump-schema`` run on a machine
without either.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

import numpy as np

from ..models.registry import get_model
from ..models.speech.family import SpeechEmbeddingModel
from ..utils import log
from .speech import convert_speech_encoder
from .store import params_path, save_params


def _config_meta_from_hf(hf_config, processor) -> dict:
    meta = dict(
        conv_dim=tuple(hf_config.conv_dim),
        conv_kernel=tuple(hf_config.conv_kernel),
        conv_stride=tuple(hf_config.conv_stride),
        conv_bias=bool(hf_config.conv_bias),
        feat_extract_norm=str(hf_config.feat_extract_norm),
        feat_proj_layer_norm=bool(getattr(hf_config, "feat_proj_layer_norm", True)),
        hidden_size=int(hf_config.hidden_size),
        num_layers=int(hf_config.num_hidden_layers),
        num_heads=int(hf_config.num_attention_heads),
        intermediate_size=int(hf_config.intermediate_size),
        do_stable_layer_norm=bool(hf_config.do_stable_layer_norm),
        layer_norm_eps=float(hf_config.layer_norm_eps),
        num_conv_pos_embeddings=int(hf_config.num_conv_pos_embeddings),
        num_conv_pos_embedding_groups=int(hf_config.num_conv_pos_embedding_groups),
    )
    if hasattr(hf_config, "num_buckets"):
        meta["attention_type"] = "wavlm"
        meta["num_buckets"] = int(hf_config.num_buckets)
        meta["max_bucket_distance"] = int(hf_config.max_bucket_distance)
    if processor is not None:
        fe = getattr(processor, "feature_extractor", processor)
        meta["do_normalize"] = bool(getattr(fe, "do_normalize", True))
    return meta


def convert_speech_model(model: SpeechEmbeddingModel) -> None:
    from dataclasses import replace

    src = model.hf_source
    log.info(f"Converting {src} ...")

    if "wavlm" in src.lower():
        from transformers import WavLMModel as HFModel
    elif "hubert" in src.lower():
        from transformers import HubertModel as HFModel
    elif "mert" in src.lower():
        # MERT ships custom modeling code; current transformers' HubertModel
        # supports its conv_pos_batch_norm flag. The reference forces that flag
        # off (fadtk/model_loader.py:270), matching HubertModel's default.
        from transformers import AutoConfig, AutoModel

        cfg = AutoConfig.from_pretrained(src, trust_remote_code=True)
        if hasattr(cfg, "conv_pos_batch_norm"):
            cfg.conv_pos_batch_norm = False
        hf = AutoModel.from_pretrained(src, trust_remote_code=True, config=cfg)
        HFModel = None
    else:
        from transformers import Wav2Vec2Model as HFModel

    if HFModel is not None:
        hf = HFModel.from_pretrained(src)

    processor = None
    try:
        from transformers import Wav2Vec2FeatureExtractor

        proc_src = src
        if "hubert" in src.lower() and "mert" not in src.lower():
            # Reference loads the -ft processor for both hubert sizes
            # (fadtk/model_loader.py:581).
            proc_src = "facebook/hubert-large-ls960-ft"
        processor = Wav2Vec2FeatureExtractor.from_pretrained(proc_src)
    except Exception as e:  # processor metadata is best-effort
        log.warning(f"Could not load processor for {src}: {e}")

    meta = _config_meta_from_hf(hf.config, processor)
    cfg = replace(model.cfg, **meta)
    params = convert_speech_encoder(hf.state_dict(), cfg)
    params["__config__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)

    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_vggish_model(checkpoint: str | None = None) -> None:
    """torch.hub harritaylor/torchvggish -> vggish.npz (reference
    fadtk/model_loader.py:99 loads the same hub checkpoint), or the hub's
    state-dict file given as ``checkpoint`` (vggish-10086976.pth)."""
    import torch

    from .vggish import convert_vggish

    if checkpoint:
        ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
        sd = ck.get("state_dict", ck) if isinstance(ck, dict) else ck
    else:
        sd = torch.hub.load("harritaylor/torchvggish", "vggish").state_dict()
    params = convert_vggish(sd)
    out = params_path("vggish")
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_whisper_model(model) -> None:
    import json as _json

    from transformers import WhisperModel as HFModel

    from .whisper import convert_whisper

    hf = HFModel.from_pretrained(model.hf_source)
    c = hf.config
    meta = dict(
        d_model=int(c.d_model),
        encoder_layers=int(c.encoder_layers),
        encoder_heads=int(c.encoder_attention_heads),
        decoder_layers=int(c.decoder_layers),
        decoder_heads=int(c.decoder_attention_heads),
        encoder_ffn=int(c.encoder_ffn_dim),
        decoder_ffn=int(c.decoder_ffn_dim),
        num_mel_bins=int(c.num_mel_bins),
        max_source_positions=int(c.max_source_positions),
        max_target_positions=int(c.max_target_positions),
        vocab_size=int(c.vocab_size),
        decoder_start_token_id=int(c.decoder_start_token_id),
    )
    from dataclasses import replace

    cfg = replace(model.cfg, **meta)
    params = convert_whisper(hf.state_dict(), cfg)
    params["__config__"] = np.frombuffer(_json.dumps(meta).encode(), dtype=np.uint8)
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_encodec_model(model) -> None:
    from transformers import EncodecModel as HFModel

    from .encodec import convert_encodec_encoder

    hf = HFModel.from_pretrained(f"facebook/encodec_{model.variant}hz")
    params = convert_encodec_encoder(hf.state_dict(), model.cfg)
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_clap_laion_model(model, checkpoint: str | None = None) -> None:
    """Convert a laion_clap .pt checkpoint (the files the reference
    auto-downloads, fadtk/model_loader.py:300-310) or the HF ClapModel tree."""
    import torch

    from .clap import convert_clap_audio

    if checkpoint:
        ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
        sd = ck.get("state_dict", ck) if isinstance(ck, dict) else ck
    else:
        from transformers import ClapModel

        hf_id = (
            "laion/clap-htsat-unfused" if model.type == "audio" else "laion/larger_clap_music"
        )
        sd = ClapModel.from_pretrained(hf_id).state_dict()

    params = convert_clap_audio(sd, model.cfg)
    if "audio_projection" not in params:
        raise ValueError("checkpoint is missing the audio projection head")
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_msclap_model(model, checkpoint: str) -> None:
    """Convert msclap CLAP_weights_2023.pth (reference fadtk/model_loader.py:472)."""
    import torch

    from .clap import convert_msclap_audio

    ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = ck.get("model", ck.get("state_dict", ck)) if isinstance(ck, dict) else ck
    params = convert_msclap_audio(sd, model.cfg)
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_dac_model(model, checkpoint: str) -> None:
    """Convert descript-audio-codec weights_44khz.pth (the file `dac download`
    fetches; reference fadtk/model_loader.py:199-200 loads tag 'latest')."""
    import torch

    from .dac import convert_dac_encoder

    ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = ck.get("state_dict", ck) if isinstance(ck, dict) else ck
    params = convert_dac_encoder(sd, model.cfg)
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out}")


def convert_cdpam_model(model, checkpoint: str) -> None:
    """Convert the cdpam package's scratch_loss checkpoint (the file
    cdpam.CDPAM() auto-downloads; reference fadtk/model_loader.py:435)."""
    import torch

    from .cdpam import convert_cdpam

    ck = torch.load(checkpoint, map_location="cpu", weights_only=False)
    params, cfg_kwargs = convert_cdpam(ck)
    params["__config__"] = np.frombuffer(
        json.dumps(cfg_kwargs).encode(), dtype=np.uint8
    )
    out = params_path(model.weights_name())
    save_params(params, out)
    log.info(f"Saved {out} (inferred geometry: {cfg_kwargs})")


def convert_model(name: str, checkpoint: str | None = None) -> None:
    from ..models.cdpam import CdpamModel
    from ..models.clap_laion import CLAPLaionModel
    from ..models.clap_ms import MSCLAPModel
    from ..models.dac import DACModel
    from ..models.encodec import EncodecEmbModel
    from ..models.whisper import WhisperModel as PortWhisper

    model = get_model(name)
    if isinstance(model, SpeechEmbeddingModel):
        convert_speech_model(model)
    elif name == "vggish":
        convert_vggish_model(checkpoint)
    elif isinstance(model, PortWhisper):
        convert_whisper_model(model)
    elif isinstance(model, EncodecEmbModel):
        convert_encodec_model(model)
    elif isinstance(model, CLAPLaionModel):
        convert_clap_laion_model(model, checkpoint)
    elif isinstance(model, MSCLAPModel):
        if not checkpoint:
            raise SystemExit(
                "clap-2023 conversion needs --checkpoint CLAP_weights_2023.pth"
            )
        convert_msclap_model(model, checkpoint)
    elif isinstance(model, DACModel):
        if not checkpoint:
            raise SystemExit(
                "dac-44kHz conversion needs --checkpoint weights_44khz.pth"
            )
        convert_dac_model(model, checkpoint)
    elif isinstance(model, CdpamModel):
        if not checkpoint:
            raise SystemExit(
                "cdpam conversion needs --checkpoint scratch_loss_*.pth "
                "(the file the cdpam pip package downloads)"
            )
        convert_cdpam_model(model, checkpoint)
    else:
        raise NotImplementedError(
            f"No converter wired for {type(model).__name__} yet"
        )


def main() -> None:
    ap = ArgumentParser(description=__doc__)
    ap.add_argument("models", nargs="*", help="registry model names")
    ap.add_argument(
        "--all-speech",
        action="store_true",
        help="convert every speech-family backbone (w2v2/hubert/wavlm/mert)",
    )
    ap.add_argument(
        "--checkpoint",
        type=str,
        default=None,
        help="local torch checkpoint path (laion_clap .pt / msclap .pth / dac .pth / "
        "cdpam .pth / torchvggish .pth)",
    )
    ap.add_argument(
        "--dry-run",
        type=str,
        default=None,
        metavar="SD_JSON",
        help="validate converter <-> checkpoint key coverage against a "
        "{key: shape} json (produced by --dump-schema) without weights; "
        "exits non-zero if any relevant key would be dropped or is missing",
    )
    ap.add_argument(
        "--dump-schema",
        nargs=2,
        default=None,
        metavar=("CKPT", "OUT_JSON"),
        help="dump a torch checkpoint's {key: shape} inventory to json "
        "(shippable to offline machines for --dry-run)",
    )
    args = ap.parse_args()

    if args.dump_schema:
        from .dryrun import dump_schema

        dump_schema(args.dump_schema[0], args.dump_schema[1])
        return

    names = list(args.models)
    if args.all_speech:
        names += [
            "w2v2-base", "w2v2-large",
            "hubert-base", "hubert-large",
            "wavlm-base", "wavlm-base-plus", "wavlm-large",
            "MERT-v1-95M",
        ]

    if args.dry_run:
        from .dryrun import dry_run_model

        for name in names:
            dry_run_model(name, args.dry_run)
        return

    for name in names:
        convert_model(name, checkpoint=args.checkpoint)


if __name__ == "__main__":
    main()
