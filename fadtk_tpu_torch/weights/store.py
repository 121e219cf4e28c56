"""Parameter storage: the JAX package's flat ``.npz`` format, read as is.

Converted weights are flat .npz archives (keys are '/'-joined tree paths; list
indices are bare numbers) under the checkpoint directory
(``FADTK_TPU_CHECKPOINTS``, default ~/.cache/fadtk_tpu) — the same files the
JAX package writes and reads, so one conversion serves both packages.

``params_from_jax`` carries such a tree into a torch ``state_dict``. The port's
modules mirror the tree's names (``nn.ModuleDict`` / ``nn.ModuleList``), so the
mapping is mechanical:

- dense ``kernel`` (in, out)        -> ``weight`` (out, in)          (nn.Linear)
- conv ``kernel`` "HIO" (K, C_in/g, C_out) -> ``weight`` (C_out, C_in/g, K)
  (nn.Conv1d; grouped convs such as the positional conv keep their group
  split, since both frameworks lay groups out contiguously along C_out)
- norm ``scale``                     -> ``weight``
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
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


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


def params_from_jax(tree) -> dict:
    """JAX parameter tree (nested dicts/lists of arrays) -> torch state_dict."""
    import torch

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
                arr = arr.transpose(2, 1, 0)
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        elif leaf == "scale":
            leaf = "weight"
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
