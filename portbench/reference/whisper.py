"""Plain reference of Whisper's embedding (the whisper-large configuration),
one clip at a time: no batching, no kernel or module of the program.

From the published definitions (Radford et al. 2022, "Robust Speech
Recognition via Large-Scale Weak Supervision", arXiv:2212.04356, and the
Hugging Face ``WhisperFeatureExtractor`` and ``WhisperModel`` it is released
as), with the keys of a configuration file of ``portbench/configs``:

- the features: the clip padded with zeros or cut to ``n_samples`` (30 s);
  a centred, reflect-padded STFT (``torch.stft``) with a periodic Hann
  window of ``n_fft``, hop ``hop_length``; the power |X|^2 with the last
  frame dropped; ``feature_size`` Slaney-normalised mel filters on the
  Slaney scale over 0 Hz to half the rate (built here from their
  definition); ``log10(max(x, 1e-10))``, the clip's floor at its maximum
  minus 8, then (x + 4) / 4: (80, 3000);
- the encoder: conv 80 -> d (kernel 3, padding 1) and GELU, conv d -> d
  (kernel 3, stride 2, padding 1) and GELU, plus the sinusoids
  [sin(t w_i), cos(t w_i)], w_i = 10000^(-i / (d/2 - 1)); pre-norm layers
  x + attention(LN(x)), x + fc2(GELU(fc1(LN(x)))); the encoder's final
  LayerNorm;
- attention: softmax(q k^T / sqrt(head_dim)) v per head, q = x W_q + b_q,
  k = kv W_k (no bias), v = kv W_v + b_v, then the output projection;
- the decoder: the two forced tokens ``decoder_start_token_id``, token
  embeddings plus learned positions 0 and 1; pre-norm layers of causal
  self-attention, attention onto the 1500 encoder states and the
  feed-forward; the decoder's final LayerNorm. Its (2, d) last hidden state
  is the clip's frames.

One departure: the sinusoids are computed in float64 and rounded to float32
once, where OpenAI's code computes them in float32 (the two differ by up
to ~1e-4 at the last positions). The weights' ``encoder.embed_positions``
is not read: the reference computes its own.

Weights come as a dict of tensors under the names the benchmark gives them
(``portbench/families/whisper.py``). Everything runs in float32; the caller
sets the TF32 switches (off for the reference, on for its control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    """The Slaney scale: linear, 3 mels per 200 Hz, below 1 kHz; logarithmic,
    27 mels per factor 6.4, above."""
    return torch.where(f < 1000.0, 3.0 * f / 200.0,
                       15.0 + 27.0 * torch.log(f.clamp(min=1e-10) / 1000.0) / math.log(6.4))


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m < 15.0, 200.0 * m / 3.0,
                       1000.0 * torch.exp(math.log(6.4) * (m - 15.0) / 27.0))


def mel_filters(cfg: dict, device) -> torch.Tensor:
    """(mels, n_fft/2 + 1) float32: triangles between mel points evenly
    spaced on the Slaney scale from 0 Hz to half the rate, in Hz on the
    FFT's bin frequencies, each scaled by 2 / (its width in Hz)."""
    mels, bins = cfg["feature_size"], cfg["n_fft"] // 2 + 1
    f64 = dict(dtype=torch.float64, device=device)
    freqs = torch.linspace(0.0, cfg["sampling_rate"] / 2, bins, **f64)
    top = _hz_to_mel(torch.tensor(cfg["sampling_rate"] / 2, **f64))
    hz = _mel_to_hz(torch.linspace(0.0, float(top), mels + 2, **f64))
    rising = (freqs[None, :] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    falling = (hz[2:, None] - freqs[None, :]) / (hz[2:] - hz[1:-1])[:, None]
    tri = torch.clamp(torch.minimum(rising, falling), min=0.0)
    return (tri * (2.0 / (hz[2:] - hz[:-2]))[:, None]).float()


def log_mel(cfg: dict, audio: torch.Tensor) -> torch.Tensor:
    """(n,) float32 audio -> (80, 3000) features."""
    n = cfg["n_samples"]
    x = F.pad(audio[:n], (0, max(n - audio.shape[0], 0)))
    window = torch.hann_window(cfg["n_fft"], periodic=True, dtype=torch.float32,
                               device=audio.device)
    spec = torch.stft(x, cfg["n_fft"], cfg["hop_length"], window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[:, :-1].abs() ** 2
    logs = torch.log10(torch.clamp(mel_filters(cfg, audio.device) @ power, min=1e-10))
    logs = torch.maximum(logs, logs.max() - 8.0)
    return (logs + 4.0) / 4.0


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32: [sin(t w_i) | cos(t w_i)], w_i =
    10000^(-i / (channels/2 - 1)), computed in float64."""
    half = channels // 2
    inv = torch.exp(-math.log(10000) / (half - 1) * torch.arange(half, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float().to(device)


def _linear(x, w, name):
    bias = w.get(f"{name}.bias")
    return F.linear(x, w[f"{name}.weight"], bias)


def _ln(x, w, name, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _attention(w, name, x, kv, heads, causal=False):
    t, d = x.shape
    hd = d // heads
    q = (_linear(x, w, f"{name}.q_proj") * hd ** -0.5).reshape(t, heads, hd).transpose(0, 1)
    k = _linear(kv, w, f"{name}.k_proj").reshape(-1, heads, hd).transpose(0, 1)
    v = _linear(kv, w, f"{name}.v_proj").reshape(-1, heads, hd).transpose(0, 1)
    logits = q @ k.transpose(1, 2)
    if causal:
        later = torch.ones(t, kv.shape[0], dtype=torch.bool, device=x.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    o = torch.softmax(logits, dim=-1) @ v
    return _linear(o.transpose(0, 1).reshape(t, d), w, f"{name}.out_proj")


def _feed_forward(w, p, x, eps):
    h = _ln(x, w, f"{p}.final_layer_norm", eps)
    return x + _linear(F.gelu(_linear(h, w, f"{p}.fc1")), w, f"{p}.fc2")


def encode(cfg: dict, w: dict, feats: torch.Tensor) -> torch.Tensor:
    """(80, 3000) features -> (1500, d) encoder states."""
    eps, heads = cfg["layer_norm_eps"], cfg["encoder_attention_heads"]
    x = F.gelu(F.conv1d(feats[None], w["encoder.conv1.weight"], w["encoder.conv1.bias"],
                        padding=1))
    x = F.gelu(F.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"], stride=2,
                        padding=1))[0].T
    x = x + sinusoids(x.shape[0], x.shape[1], x.device)
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.layers.{i}"
        h = _ln(x, w, f"{p}.self_attn_layer_norm", eps)
        x = x + _attention(w, f"{p}.self_attn", h, h, heads)
        x = _feed_forward(w, p, x, eps)
    return _ln(x, w, "encoder.layer_norm", eps)


def decode(cfg: dict, w: dict, states: torch.Tensor) -> torch.Tensor:
    """(1500, d) encoder states -> (2, d) last hidden state of the decoder
    fed the two forced start tokens."""
    eps, heads = cfg["layer_norm_eps"], cfg["decoder_attention_heads"]
    tokens = torch.full((2,), cfg["decoder_start_token_id"], dtype=torch.long,
                        device=states.device)
    x = w["decoder.embed_tokens"][tokens] + w["decoder.embed_positions"][:2]
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.layers.{i}"
        h = _ln(x, w, f"{p}.self_attn_layer_norm", eps)
        x = x + _attention(w, f"{p}.self_attn", h, h, heads, causal=True)
        h = _ln(x, w, f"{p}.encoder_attn_layer_norm", eps)
        x = x + _attention(w, f"{p}.encoder_attn", h, states, heads)
        x = _feed_forward(w, p, x, eps)
    return _ln(x, w, "decoder.layer_norm", eps)


def forward(cfg: dict, w: dict, audio: torch.Tensor) -> torch.Tensor:
    """(n,) float32 audio at 16 kHz -> (2, d) float32 frames."""
    return decode(cfg, w, encode(cfg, w, log_mel(cfg, audio)))
