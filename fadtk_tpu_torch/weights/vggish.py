"""Checkpoint -> parameter tree conversion for VGGish (torch.hub harritaylor/torchvggish).

The port of ``fadtk_tpu/weights/vggish.py``, line for line: the tree is the JAX
package's, saved as the same flat ``.npz`` (``store.save_params``), so one
conversion serves both packages.

torchvggish module tree: ``features`` = Sequential with convs at indices
(0, 3, 6, 8, 11, 13) interleaved with ReLU/MaxPool; ``embeddings`` = Sequential
(Linear, ReLU, Linear, ReLU, Linear[, ReLU stripped by the reference]) with
linears at (0, 2, 4).

The fc1 input ordering needs no permutation: torchvggish flattens NCHW via two
transposes into (h, w, c) order (its VGG.forward), which equals the natural
NHWC flatten used by our forward.
"""

from __future__ import annotations

import numpy as np

_CONV_IDX = (0, 3, 6, 8, 11, 13)
_FC_IDX = (0, 2, 4)


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy(), dtype=np.float32)


def convert_vggish(state_dict) -> dict:
    features = [
        {
            "kernel": _t(state_dict[f"features.{i}.weight"]).transpose(2, 3, 1, 0),
            "bias": _t(state_dict[f"features.{i}.bias"]),
        }
        for i in _CONV_IDX
    ]
    fcs = [
        {
            "kernel": _t(state_dict[f"embeddings.{i}.weight"]).T,
            "bias": _t(state_dict[f"embeddings.{i}.bias"]),
        }
        for i in _FC_IDX
    ]
    return {"features": features, "fc1": fcs[0], "fc2": fcs[1], "fc3": fcs[2]}
