"""Configuration for the shared speech-transformer encoder family.

One config covers wav2vec 2.0, HuBERT, WavLM and MERT — the reference treats
them as the same embedding pattern with per-model checkpoints and a hidden-state
layer tap (reference fadtk/model_loader.py:525-633, 254-288).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SpeechEncoderConfig:
    # Convolutional feature extractor (waveform -> ~50 Hz frames).
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # 'group' (base models) | 'layer' (large/stable)

    # Feature projection.
    feat_proj_layer_norm: bool = True

    # Transformer encoder.
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    do_stable_layer_norm: bool = False  # pre-norm layers + final LN when True
    layer_norm_eps: float = 1e-5

    # Convolutional relative positional embedding.
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16

    # Attention flavor: 'standard' (w2v2/hubert/mert) or 'wavlm'
    # (gated relative position bias; reference model patrickvonplaten/wavlm-*).
    attention_type: str = "standard"
    num_buckets: int = 320
    max_bucket_distance: int = 800

    # Input feature normalization (HF processor zero-mean/unit-var, eps 1e-7).
    do_normalize: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_output_frames(self, num_samples: int) -> int:
        """Valid frame count after the conv extractor for a raw length."""
        n = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return max(n, 0)


def base_config(**kw) -> SpeechEncoderConfig:
    """wav2vec2/hubert 'base' geometry (768 x 12)."""
    return SpeechEncoderConfig(**kw)


def large_config(**kw) -> SpeechEncoderConfig:
    """'large' geometry (1024 x 24)."""
    defaults = dict(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
    )
    defaults.update(kw)
    return SpeechEncoderConfig(**defaults)
