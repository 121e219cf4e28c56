"""Recorded checkpoint key inventories for the non-HF converters.

The port of ``fadtk_tpu/weights/schemas.py``, line for line. These generators
transcribe the PUBLISHED checkpoint key schemas (names + shapes) as an
assertion target independent of any test-local torch mirror; the dry-run
machinery (weights/dryrun.py) checks the real converters against them.

Provenance per generator is documented inline. When a real checkpoint is
available, ``python -m fadtk_tpu_torch.weights.convert_cli --dump-schema ck.pth ck.json`` produces the actual
inventory and supersedes these transcriptions.
"""

from __future__ import annotations

import math


def dac_44khz_encoder_schema() -> dict[str, tuple]:
    """descript-audio-codec 44 kHz encoder inventory.

    Transcribed from dac/model/dac.py (descript-audio-codec v1.0.0):

        Encoder(d_model=64, strides=[2,4,8,8], d_latent=1024):
          block.0                WNConv1d(1, 64, k=7, p=3)
          block.{1..4}           EncoderBlock(dim = 64*2^i, stride = s_i):
            .block.{0,1,2}       ResidualUnit(dim//2, dilation = 1, 3, 9):
              .block.0 / .2      Snake1d(dim//2)        -> alpha (1, C, 1)
              .block.1           WNConv1d(C, C, k=7, dilation=d)
              .block.3           WNConv1d(C, C, k=1)
            .block.3             Snake1d(dim//2)
            .block.4             WNConv1d(dim//2, dim, k=2*stride, stride)
          block.5                Snake1d(1024)
          block.6                WNConv1d(1024, latent=1024, k=3)

    Weight norm uses the classic torch parametrization: ``weight_g``
    (out, 1, 1), ``weight_v`` (out, in, k), plus ``bias`` (out,). The DAC
    checkpoint also carries decoder.* and quantizer.* subtrees the embedding
    path never touches; a representative sample is included so coverage
    reports exercise the relevant/irrelevant split.
    """
    schema: dict[str, tuple] = {}

    def wnconv(prefix, cin, cout, k):
        schema[f"{prefix}.weight_g"] = (cout, 1, 1)
        schema[f"{prefix}.weight_v"] = (cout, cin, k)
        schema[f"{prefix}.bias"] = (cout,)

    def snake(prefix, c):
        schema[f"{prefix}.alpha"] = (1, c, 1)

    strides = (2, 4, 8, 8)
    d = 64
    wnconv("encoder.block.0", 1, d, 7)
    for i, s in enumerate(strides):
        d *= 2
        half = d // 2
        p = f"encoder.block.{i + 1}"
        for j, _dil in enumerate((1, 3, 9)):
            r = f"{p}.block.{j}"
            snake(f"{r}.block.0", half)
            wnconv(f"{r}.block.1", half, half, 7)
            snake(f"{r}.block.2", half)
            wnconv(f"{r}.block.3", half, half, 1)
        snake(f"{p}.block.3", half)
        wnconv(f"{p}.block.4", half, d, 2 * s)
    snake("encoder.block.5", d)
    wnconv("encoder.block.6", d, 1024, 3)

    # Representative slices of the subtrees fadtk never uses (full decoder /
    # quantizer inventories are large; the dry-run only needs to see that
    # out-of-subtree keys exist and are not flagged).
    wnconv("decoder.model.0", 1024, 1536, 7)
    schema["quantizer.quantizers.0.codebook.weight"] = (1024, 8)
    schema["quantizer.quantizers.0.in_proj.weight_g"] = (8, 1, 1)
    schema["quantizer.quantizers.0.in_proj.weight_v"] = (8, 1024, 1)
    schema["quantizer.quantizers.0.in_proj.bias"] = (8,)
    return schema


def hf_clap_audio_schema() -> dict[str, tuple]:
    """HF transformers ClapModel inventory — REAL ground truth, generated from
    the locally installed transformers library (no network: ClapConfig()
    defaults construct the laion/clap-htsat-unfused architecture)."""
    import torch  # noqa: F401
    from transformers import ClapConfig, ClapModel

    with torch.device("meta"):
        model = ClapModel(ClapConfig())
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _htsat_tower_schema(prefix: str, embed_dim: int = 96,
                        depths=(2, 2, 6, 2), heads=(4, 8, 16, 32),
                        window: int = 8, mel_bins: int = 64,
                        n_fft: int = 1024, classes: int = 527) -> dict[str, tuple]:
    """Original HTSAT_Swin_Transformer state-dict inventory (Ke Chen's
    HTS-Audio-Transformer as vendored verbatim by both laion_clap and msclap).

    Transcribed from htsat.py: torchlibrosa Spectrogram/LogmelFilterBank
    frontend buffers, bn0 over mel bins, PatchEmbed(4x4 -> embed_dim), four
    Swin stages (fused qkv attention with a (2w-1)^2 x heads relative-position
    bias table, PatchMerging 4C->2C bias-free reductions), final LayerNorm,
    and the token-semantic head (tscam_conv + head) that the embedding path
    never evaluates (CLAP taps latent_output before it). Shifted blocks also
    register attn_mask buffers whose shapes depend on padded resolution;
    they carry no weights and the dry-run ignores them, so they are omitted.
    """
    s: dict[str, tuple] = {}
    freq_bins = n_fft // 2 + 1
    s[f"{prefix}spectrogram_extractor.stft.conv_real.weight"] = (freq_bins, 1, n_fft)
    s[f"{prefix}spectrogram_extractor.stft.conv_imag.weight"] = (freq_bins, 1, n_fft)
    s[f"{prefix}logmel_extractor.melW"] = (freq_bins, mel_bins)
    for k in ("weight", "bias", "running_mean", "running_var"):
        s[f"{prefix}bn0.{k}"] = (mel_bins,)
    s[f"{prefix}bn0.num_batches_tracked"] = ()
    s[f"{prefix}patch_embed.proj.weight"] = (embed_dim, 1, 4, 4)
    s[f"{prefix}patch_embed.proj.bias"] = (embed_dim,)
    s[f"{prefix}patch_embed.norm.weight"] = (embed_dim,)
    s[f"{prefix}patch_embed.norm.bias"] = (embed_dim,)
    table = (2 * window - 1) ** 2
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed_dim * (2 ** i)
        for j in range(depth):
            p = f"{prefix}layers.{i}.blocks.{j}"
            for n in ("norm1", "norm2"):
                s[f"{p}.{n}.weight"] = (c,)
                s[f"{p}.{n}.bias"] = (c,)
            s[f"{p}.attn.relative_position_bias_table"] = (table, h)
            s[f"{p}.attn.relative_position_index"] = (window * window, window * window)
            s[f"{p}.attn.qkv.weight"] = (3 * c, c)
            s[f"{p}.attn.qkv.bias"] = (3 * c,)
            s[f"{p}.attn.proj.weight"] = (c, c)
            s[f"{p}.attn.proj.bias"] = (c,)
            s[f"{p}.mlp.fc1.weight"] = (4 * c, c)
            s[f"{p}.mlp.fc1.bias"] = (4 * c,)
            s[f"{p}.mlp.fc2.weight"] = (c, 4 * c)
            s[f"{p}.mlp.fc2.bias"] = (c,)
        if i < len(depths) - 1:
            s[f"{prefix}layers.{i}.downsample.reduction.weight"] = (2 * c, 4 * c)
            s[f"{prefix}layers.{i}.downsample.norm.weight"] = (4 * c,)
            s[f"{prefix}layers.{i}.downsample.norm.bias"] = (4 * c,)
    d_latent = embed_dim * (2 ** (len(depths) - 1))
    s[f"{prefix}norm.weight"] = (d_latent,)
    s[f"{prefix}norm.bias"] = (d_latent,)
    # Token-semantic module: SF = spec_size/2^(len(depths)-1)/patch_stride/freq_ratio
    # = 256/8/4/(256/64) = 2 for every CLAP variant in play.
    s[f"{prefix}tscam_conv.weight"] = (classes, d_latent, 2, 3)
    s[f"{prefix}tscam_conv.bias"] = (classes,)
    s[f"{prefix}head.weight"] = (classes, classes)
    s[f"{prefix}head.bias"] = (classes,)
    return s


def msclap_2023_audio_schema() -> dict[str, tuple]:
    """msclap CLAP_weights_2023.pth inventory (the 'model' entry), transcribed
    from the published microsoft/CLAP source (msclap/models/):

    - clap.py CLAP: audio_encoder (AudioEncoder), caption_encoder
      (TextEncoder), logit_scale;
    - audio.py AudioEncoder: ``base`` = HTSATWrapper whose ``htsat`` holds the
      original HTSAT_Swin_Transformer (audioenc_name='HTSAT', out_emb=768 —
      tiny geometry), ``projection`` = Projection(768, d_proj=1024);
    - clap.py Projection: linear1/linear2 are nn.Linear(..., bias=False) —
      only the layer_norm carries a bias;
    - the 2023 caption encoder is GPT-2 (a representative key slice is
      included so the irrelevant-subtree split is exercised).

    Offline caveat: transcribed from source text, not dumped from the real
    file — supersede with ``convert_cli --dump-schema`` output when the
    checkpoint is reachable. The mel fmin/fmax defaults (models/clap_ms.py)
    remain the config_2023.yml values as best known offline.
    """
    s = _htsat_tower_schema("audio_encoder.base.htsat.")
    s["audio_encoder.projection.linear1.weight"] = (1024, 768)
    s["audio_encoder.projection.linear2.weight"] = (1024, 1024)
    s["audio_encoder.projection.layer_norm.weight"] = (1024,)
    s["audio_encoder.projection.layer_norm.bias"] = (1024,)
    # Text tower slice (GPT-2 base) + scale: outside the audio subtree.
    s["caption_encoder.base.transformer.wte.weight"] = (50257, 768)
    s["caption_encoder.base.transformer.h.0.attn.c_attn.weight"] = (768, 2304)
    s["caption_encoder.base.transformer.h.0.attn.c_attn.bias"] = (2304,)
    s["caption_encoder.base.transformer.ln_f.weight"] = (768,)
    s["caption_encoder.projection.linear1.weight"] = (1024, 768)
    s["caption_encoder.projection.linear2.weight"] = (1024, 1024)
    s["caption_encoder.projection.layer_norm.weight"] = (1024,)
    s["caption_encoder.projection.layer_norm.bias"] = (1024,)
    s["logit_scale"] = ()
    return s


def laion_clap_pt_schema(amodel: str = "HTSAT-tiny") -> dict[str, tuple]:
    """laion_clap .pt checkpoint inventory (630k-audioset-best.pt /
    music_audioset_epoch_15_esc_90.14.pt; reference
    fadtk/model_loader.py:300-310), transcribed from the published laion_clap
    source (clap_module/model.py CLAP): DDP 'module.'-prefixed keys;
    ``audio_branch`` = the same vendored HTSAT tower; ``audio_projection`` =
    Sequential(Linear(768, 512), ReLU, Linear(512, 512)) with biases at
    indices 0 and 2; text tower (roberta) + text_projection + logit scales
    outside the audio subtree (representative slice).

    HTSAT-base (clap-laion-music's amodel) scales embed_dim to 128.
    Offline caveat: transcribed, not dumped — supersede with --dump-schema.
    """
    embed_dim = {"HTSAT-tiny": 96, "HTSAT-base": 128}[amodel]
    d_latent = embed_dim * 8
    s = _htsat_tower_schema("module.audio_branch.", embed_dim=embed_dim)
    s["module.audio_projection.0.weight"] = (512, d_latent)
    s["module.audio_projection.0.bias"] = (512,)
    s["module.audio_projection.2.weight"] = (512, 512)
    s["module.audio_projection.2.bias"] = (512,)
    # Text tower slice (roberta-base) + scales: outside the audio subtree.
    s["module.text_branch.embeddings.word_embeddings.weight"] = (50265, 768)
    s["module.text_branch.encoder.layer.0.attention.self.query.weight"] = (768, 768)
    s["module.text_projection.0.weight"] = (512, 768)
    s["module.text_projection.0.bias"] = (512,)
    s["module.text_projection.2.weight"] = (512, 512)
    s["module.text_projection.2.bias"] = (512,)
    s["module.logit_scale_a"] = ()
    s["module.logit_scale_t"] = ()
    return s


def vggish_schema() -> dict[str, tuple]:
    """torch.hub harritaylor/torchvggish state-dict inventory, transcribed
    from the published torchvggish source (torchvggish/vggish.py VGG):
    ``features`` = make_layers([64, M, 128, M, 256, 256, M, 512, 512, M])
    (convs at Sequential indices 0, 3, 6, 8, 11, 13), ``embeddings`` =
    Sequential(Linear(512*4*6, 4096), ReLU, Linear(4096, 4096), ReLU,
    Linear(4096, 128), ReLU) (linears at 0, 2, 4). The PCA postprocessor the
    reference disables (fadtk/model_loader.py:100-101) lives outside this
    state dict (a separate hub artifact)."""
    s: dict[str, tuple] = {}
    chans = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512)]
    for idx, (cin, cout) in zip((0, 3, 6, 8, 11, 13), chans):
        s[f"features.{idx}.weight"] = (cout, cin, 3, 3)
        s[f"features.{idx}.bias"] = (cout,)
    for idx, (din, dout) in zip((0, 2, 4), [(12288, 4096), (4096, 4096), (4096, 128)]):
        s[f"embeddings.{idx}.weight"] = (dout, din)
        s[f"embeddings.{idx}.bias"] = (dout,)
    return s


def cdpam_base_encoder_schema(channels=(64,) * 5 + (128,) * 5 + (256,) * 5 + (512,),
                              kernel_size: int = 3, emb_dim: int = 512) -> dict[str, tuple]:
    """CDPAM ``base_encoder`` inventory at the geometry the models assume
    (``models/cdpam_impl.py::CdpamConfig``: 16 Conv1d of kernel 3, each with
    a BatchNorm1d, and the acoustic and content linear heads), under the key
    names the schema-driven converter discovers (``convs.{i}``,
    ``norms.{i}``, ``fc_acoustic``, ``fc_content``), wrapped as the
    cdpam package's ``{'state': ...}`` FINnet tree with a classifier head
    outside the subtree.

    Offline caveat: the geometry is the models' default, not dumped from the
    real file — supersede with ``convert_cli --dump-schema`` output when the
    checkpoint is reachable; the converter infers whatever geometry it finds.
    """
    s: dict[str, tuple] = {}
    cin = 1
    for i, c in enumerate(channels):
        s[f"base_encoder.convs.{i}.weight"] = (c, cin, kernel_size)
        s[f"base_encoder.convs.{i}.bias"] = (c,)
        for k in ("weight", "bias", "running_mean", "running_var"):
            s[f"base_encoder.norms.{i}.{k}"] = (c,)
        s[f"base_encoder.norms.{i}.num_batches_tracked"] = ()
        cin = c
    for head in ("fc_acoustic", "fc_content"):
        s[f"base_encoder.{head}.weight"] = (emb_dim, cin)
        s[f"base_encoder.{head}.bias"] = (emb_dim,)
    s["model_classifier.0.weight"] = (16, 2 * emb_dim)
    s["model_classifier.0.bias"] = (16,)
    return s
