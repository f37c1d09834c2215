"""Multi-host set-up: the process group from a launcher's environment, and
a host x chip mesh.

PyTorch port of ``raytracinginonesemester_tpu.parallel.multihost``.  The
JAX package runs one process per host over all of its chips; here every
chip is a process of its own (``torchrun --nproc-per-node N`` on each
host), so a "host" is the ``LOCAL_WORLD_SIZE`` consecutive ranks that the
launcher starts on one machine.  The model axis stays inside a host,
where its per-bounce hit merges ride the fast links (NVLink), and the
data axis, which communicates once a frame, spans hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch.distributed as dist

from .sharded import Mesh, make_mesh

__all__ = ["initialize_multihost", "host_chip_mesh", "is_multihost"]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_multihost(backend: str,
                         coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Initialise the default process group when the job has more than one
    process; returns False (and does nothing) for a single process.

    ``backend``: "nccl" for one process per GPU, "gloo" for the CPU or for
    ranks that share a card.  The other arguments default to torchrun's
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, or the
    JAX package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``."""
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        else:
            coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if num_processes in (None, 1):
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address and this process's rank")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def is_multihost() -> bool:
    """Whether this process is one of several in a process group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_chip_mesh(axis_names: Tuple[str, str] = ("data", "model"),
                   model_parallel_per_host: int = 1) -> Mesh:
    """Mesh (ranks / mp, mp) with the model axis confined to one host's
    chips (``LOCAL_WORLD_SIZE`` ranks a host, default all of them)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    per_host = _env_int("LOCAL_WORLD_SIZE") or n
    mp = int(model_parallel_per_host)
    if mp < 1 or mp > per_host or per_host % mp or n % per_host:
        raise ValueError(f"model_parallel_per_host={mp} must divide "
                         f"chips/host={per_host} (of {n} ranks)")
    return make_mesh((n // mp, mp), axis_names)
