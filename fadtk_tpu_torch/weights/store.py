"""Parameter storage: the JAX package's flat ``.npz`` format, read as is.

Converted weights are flat .npz archives (keys are '/'-joined tree paths; list
indices are bare numbers) under the checkpoint directory
(``FADTK_TPU_CHECKPOINTS``, default ~/.cache/fadtk_tpu) — the same files the
JAX package writes and reads, so one conversion serves both packages.

``params_from_jax`` carries such a tree into a torch ``state_dict``. The port's
modules mirror the tree's names (``nn.ModuleDict`` / ``nn.ModuleList``), so the
mapping is mechanical:

- dense ``kernel`` (in, out)        -> ``weight`` (out, in)          (nn.Linear)
- conv ``kernel`` -> ``weight`` (C_out, C_in/g, K), from the layout the family
  stores (``conv_layout``):
  - "HIO" (K, C_in/g, C_out), the speech encoder's: transposed (grouped convs
    such as the positional conv keep their group split, since both
    frameworks lay groups out contiguously along C_out);
  - "OIH" (C_out, C_in, K), the codec encoders' (EnCodec, DAC), which keep
    PyTorch's order: unchanged;
- 2-D conv ``kernel`` HWIO (KH, KW, C_in, C_out), VGGish's -> ``weight``
  OIHW (C_out, C_in, KH, KW)                                     (nn.Conv2d)
- norm ``scale``                     -> ``weight``
- LSTM layer ``j``'s ``layers/{j}/w_ih|w_hh|b_ih|b_hh`` -> ``lstm.weight_ih_l{j}``,
  ``weight_hh_l{j}``, ``bias_ih_l{j}``, ``bias_hh_l{j}`` (nn.LSTM; same gate
  order i, f, g, o)
- ``bias`` and everything else       -> unchanged
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..utils import PathLike


def checkpoint_dir() -> Path:
    return Path(
        os.environ.get("FADTK_TPU_CHECKPOINTS", Path.home() / ".cache" / "fadtk_tpu")
    )


def flatten_pytree(tree, prefix="") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_pytree(flat: dict[str, np.ndarray]):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        # Only 0..n-1 was a list: EnCodec's layers dict is keyed by HF layer
        # index with gaps (no entry for the parameter-free ELUs).
        if keys and set(keys) == {str(i) for i in range(len(keys))}:
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(params, path: PathLike) -> None:
    """Write a parameter tree as the flat ``.npz`` both packages read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten_pytree(params))


def load_params(path: PathLike):
    with np.load(path) as data:
        return unflatten_pytree({k: data[k] for k in data.files})


def decode_config_meta(meta) -> dict:
    """Decode a stored ``__config__`` uint8 blob back to config kwargs.

    JSON round-trips tuples as lists; frozen config dataclasses stay hashable,
    so sequence fields are re-tupled.
    """
    fields = json.loads(bytes(np.asarray(meta)).decode())
    return {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}


_LSTM_LEAVES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}


def params_from_jax(tree, conv_layout: str = "HIO") -> dict:
    """JAX parameter tree (nested dicts/lists of arrays) -> torch state_dict.
    ``conv_layout``: how the family stores 3-D conv kernels, "HIO" (speech
    encoder, Whisper) or "OIH" (codec encoders); 4-D kernels are HWIO."""
    import torch

    if conv_layout not in ("HIO", "OIH"):
        raise ValueError(f"conv_layout must be 'HIO' or 'OIH', got {conv_layout!r}")
    state = {}
    for key, arr in flatten_pytree(tree).items():
        *path, leaf = key.split("/")
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":  # ml_dtypes arrays have no torch twin
            arr = arr.astype(np.float32)
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                if conv_layout == "HIO":
                    arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        elif leaf == "scale":
            leaf = "weight"
        elif leaf in _LSTM_LEAVES and len(path) >= 2 and path[-2] == "layers":
            leaf = f"{_LSTM_LEAVES[leaf]}_l{int(path[-1])}"
            path = [*path[:-2], "lstm"]
        state[".".join([*path, leaf])] = torch.tensor(arr)  # copies: JAX arrays are read-only
    return state


def params_path(model_name: str) -> Path:
    return checkpoint_dir() / f"{model_name}.npz"


def random_weights_enabled() -> bool:
    """Explicit test/bench mode: run models with random weights instead of
    converted checkpoints (no network on the machines that run this)."""
    return os.environ.get("FADTK_TPU_RANDOM_WEIGHTS", "0") == "1"


class MissingWeightsError(RuntimeError):
    def __init__(self, model_name: str, hint: str):
        super().__init__(
            f"No converted weights found for '{model_name}' at {params_path(model_name)}.\n"
            f"Run `fadtk-convert {model_name}` on a machine with the upstream "
            f"checkpoint available ({hint}), or set FADTK_TPU_RANDOM_WEIGHTS=1 "
            "for shape/pipeline testing with random weights."
        )
