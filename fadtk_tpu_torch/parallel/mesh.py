"""The (dp, tp) process mesh of the device pipeline.

The port of ``fadtk_tpu/parallel/mesh.py``. The embedding sweep is data
parallel over clips (``dp``) and optionally tensor parallel over attention
heads and FFN columns (``tp``). Statistics partials merge across ``dp`` with
``all_reduce`` (``metric.stats.welford_merge_across``); the row-parallel
products sum across ``tp`` (``parallel.tp``).

One design difference from the JAX package, which drives every local device
from one process: PyTorch runs one process per GPU. So

- a single process (no ``torch.distributed`` process group) is dp = tp = 1 on
  ``utils.resolve_device()``'s device;
- several GPUs need a ``torchrun`` launch, one process per GPU
  (``torchrun --nproc-per-node N -m fadtk_tpu_torch <model> a b
  --device-pipeline --tp T``). ``make_mesh`` then initialises the process
  group from torchrun's environment: NCCL when the device is CUDA, gloo on
  the CPU. A caller may also initialise it first, with any backend;
- ``n_devices > 1`` without such a launch raises ``SystemExit`` naming
  torchrun.

The ranks form a (dp, tp) grid with tp contiguous, as JAX's
``reshape(dp, tp)`` of the device list: rank r has dp_rank r // tp and
tp_rank r % tp.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..utils import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, tp) grid, its two process groups (None
    where the axis has one rank) and its device."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    device: torch.device
    dp_group: object = field(default=None, compare=False, repr=False)
    tp_group: object = field(default=None, compare=False, repr=False)

    @property
    def rank(self) -> int:
        """Global rank: tp is the contiguous axis."""
        return self.dp_rank * self.tp + self.tp_rank


def tp_groups(world: int, tp: int) -> list[list[int]]:
    """The ranks of each tp group, dp index by dp index: consecutive ranks."""
    return [list(range(d * tp, (d + 1) * tp)) for d in range(world // tp)]


def _launched_by_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ


def make_mesh(n_devices: int | None = None, tp: int | None = None) -> Mesh:
    """Build this rank's (dp, tp) mesh over all ranks of the job.

    ``tp`` defaults to 1 (pure data parallelism). ``n_devices``, where given,
    must equal the number of ranks.
    """
    tp = tp or 1
    if not dist.is_initialized() and _launched_by_torchrun():
        device = resolve_device()
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        if (n_devices or 1) > 1 or tp > 1:
            raise SystemExit(
                f"--devices {n_devices or 1} / --tp {tp}: fadtk_tpu_torch runs one process "
                "per GPU; launch it with `torchrun --nproc-per-node N -m fadtk_tpu_torch ...`"
            )
        return Mesh(dp=1, tp=1, dp_rank=0, tp_rank=0, device=resolve_device())

    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise SystemExit(f"--devices {n_devices}: this job has {world} processes (one per device)")
    if world % tp:
        raise SystemExit(f"{world} devices not divisible by tp={tp}")
    dp = world // tp
    device = resolve_device()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    # Every rank creates every group, in the same order (new_group is
    # collective); an axis of one rank gets none.
    dp_group = tp_group = None
    if tp > 1:
        for d, ranks in enumerate(tp_groups(world, tp)):
            g = dist.new_group(ranks)
            if d == rank // tp:
                tp_group = g
    if dp > 1:
        for i in range(tp):
            g = dist.new_group([d * tp + i for d in range(dp)])
            if i == rank % tp:
                dp_group = g
    return Mesh(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp, device=device,
                dp_group=dp_group, tp_group=tp_group)
