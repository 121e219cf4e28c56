"""Multi-node initialisation: one process per GPU over several machines.

The port of ``fadtk_tpu/parallel/multihost.py``. Every process of the job
calls ``initialize()`` once, before anything touches the device; the
(dp, tp) mesh then spans all ranks, with tp contiguous (``mesh.make_mesh``),
so each tp group's row-parallel ``all_reduce`` stays inside one node
(NVLink) and only the dp merge of the (D, D) statistics crosses nodes —
one array per dataset, whatever the scale
(``metric.stats.welford_merge_across``).

Launch it with a multi-node ``torchrun``, the same command on every node:

    torchrun --nnodes N --node-rank R --nproc-per-node G \\
        --master-addr HOST0 --master-port PORT \\
        -m fadtk_tpu_torch <model> <a> <b> --device-pipeline --multihost [--tp T]

or, without torchrun, pass the coordinator's ``host:port``, the process count
and this process's rank to ``initialize``.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..utils import log, resolve_device
from .mesh import make_mesh, tp_groups


def _torchrun_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the job's process group: NCCL when the device is CUDA, gloo on
    the CPU.

    Under ``torchrun`` the rank, world size and coordinator come from its
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). Otherwise all three arguments are needed
    (``init_method="tcp://<coordinator_address>"``).
    """
    device = resolve_device()
    backend = "nccl" if device.type == "cuda" else "gloo"
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    if _torchrun_env() and coordinator_address is None:
        dist.init_process_group(backend)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise SystemExit(
                "--multihost: launch under torchrun (--nnodes N --node-rank R ...), or pass "
                "initialize() the coordinator address, process count and process id"
            )
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    log.info(
        f"torch.distributed initialized ({backend}): process {dist.get_rank()}/"
        f"{dist.get_world_size()}, {local} local / {dist.get_world_size()} global devices"
    )


def check_tp_within_nodes(nodes: list, tp: int, local: int) -> None:
    """Refuse a tp degree whose groups would cross nodes. ``nodes[r]`` names
    rank r's node; ``local`` is the process count of one node."""
    if local % tp:
        raise ValueError(
            f"tp={tp} must divide the local process count {local} so tensor-parallel "
            "collectives stay within one node"
        )
    for group in tp_groups(len(nodes), tp):
        spans = {nodes[r] for r in group}
        if len(spans) > 1:
            raise ValueError(
                f"tp group {group} spans nodes {sorted(map(str, spans))}: tensor-parallel "
                "collectives must stay within one node"
            )


def global_mesh(tp: int = 1):
    """This rank's (dp, tp) mesh over every rank of the job, after checking
    that each tp group lies on one node. A rank's node is torchrun's
    ``GROUP_RANK`` (the node rank), else its host name; all ranks gather
    them, so every rank reaches the same verdict."""
    if not dist.is_initialized():
        raise RuntimeError("multihost.global_mesh: call multihost.initialize() first")
    node = os.environ.get("GROUP_RANK") or socket.gethostname()
    nodes: list = [None] * dist.get_world_size()
    dist.all_gather_object(nodes, node)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or nodes.count(node)
    check_tp_within_nodes(nodes, tp, local)
    return make_mesh(tp=tp)
