"""A kernel's own layout of some tensors (padded, folded or packed bases and
weights), built once per tensor set and kept while its first tensor lives.

The port's kernels read weights and bases in layouts of their own; the
tensors they come from do not change after load, so a wrapper builds the
layout at the first call and finds it again at every later one. An entry is
keyed on its first tensor (weakly: it goes with the tensor) and holds the
signature of the whole set, so a set with other memory, or a tensor written
in place, builds again. Views of the same parameter (the ``weight[:, :, 0]``
a model passes on every call) have the same signature and hit.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

import torch
from torch.utils.weak import WeakIdKeyDictionary

T = TypeVar("T")


def signature(t: torch.Tensor) -> tuple:
    """What identifies a tensor's contents while it lives: its memory, shape,
    strides and in-place write counter. Inference tensors (made under
    ``torch.inference_mode``) keep no counter and cannot be written outside
    inference mode: -1."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device,
            -1 if t.is_inference() else t._version)


class LayoutCache(Generic[T]):
    """``cache(*tensors)`` is ``build(*tensors)``, built once per tensor set;
    ``builds`` counts the builds (tests read it)."""

    def __init__(self, build: Callable[..., T]):
        self._build = build
        self._entries = WeakIdKeyDictionary()
        self.builds = 0

    def __call__(self, *tensors: torch.Tensor) -> T:
        sig = tuple(signature(t) for t in tensors)
        hit = self._entries.get(tensors[0])
        if hit is not None and hit[0] == sig:
            return hit[1]
        layout = self._build(*tensors)
        self.builds += 1
        self._entries[tensors[0]] = (sig, layout)
        return layout
