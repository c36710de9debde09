"""Process-group setup (``deep_q_learning_tpu/parallel/mesh.py``).

The JAX package shards envs over a 1-D ``("env",)`` device mesh.  Here
the "mesh" is a ``torch.distributed`` process group: one rank a shard of
the envs, each rank on its own device, the learner replicated on every
rank and its gradients all-reduced over the group
(``parallel/distributed.py``).  ``ENV_AXIS`` keeps the JAX axis name for
docs and logs; no ``Mesh`` or ``NamedSharding`` object has a counterpart.

Backends: NCCL for CUDA tensors when every rank has a device of its own,
gloo for CPU tensors, and gloo for CUDA tensors where ranks share one
device (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_AXIS = "env"

# the environment variables torchrun sets for every rank
_TORCHRUN_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join (or make) the default process group.

    Three launch modes, as in the JAX package:
      * explicit: ``coordinator_address`` ("host:port"), ``num_processes``
        and ``process_id``;
      * ``torchrun``: no arguments, and ``MASTER_ADDR``, ``RANK`` and
        ``WORLD_SIZE`` in the environment;
      * standalone: no arguments and none of those variables; the process
        runs as world size 1 (an in-process store, no port).
    An explicit or ``torchrun`` launch that fails raises: it never degrades
    to a standalone run.  Idempotent: a second call is a no-op.

    ``backend=None`` picks NCCL for a CUDA ``device`` and gloo for the CPU.
    ``backend="gloo"`` with CUDA tensors is allowed: it is how two ranks
    share one card."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit launch needs num_processes and process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    elif all(v in os.environ for v in _TORCHRUN_VARS):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)


def world_size(group=None) -> int:
    """Ranks in ``group`` (the default group if None); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group`` (the default group if None); 0
    without one."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def rank_device(device) -> torch.device:
    """The device of this rank: a CUDA ``device`` without an index becomes
    ``cuda:{LOCAL_RANK % device_count}``; any other device is returned as
    it is.  Raises where the backend is NCCL and two ranks of this host
    would share a device."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    local_rank = int(os.environ.get("LOCAL_RANK", rank()))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    if dist.is_initialized() and dist.get_backend() == "nccl" and local_world > count:
        raise RuntimeError(
            f"{local_world} NCCL ranks on this host but {count} GPU(s): NCCL cannot run "
            "two ranks on one device; use backend='gloo' to share a device"
        )
    return torch.device("cuda", local_rank % count)
