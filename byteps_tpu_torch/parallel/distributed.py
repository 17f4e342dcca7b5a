"""The multi-process runtime: the job's process group and the helpers
around it.

Port of byteps_tpu/parallel/distributed.py. JAX bootstraps its
coordination service (``jax.distributed.initialize``) at the address of
the BytePS scheduler's port block; here the same address is the
``tcp://`` rendezvous of ``torch.distributed.init_process_group``, with
NCCL on the card and gloo on the CPU.

One process group per job: ``ensure_initialized`` makes the default
group unless one exists, and ``core/state.py``'s ``init``, which owns
the ``dp`` group of ``push_pull``, takes an existing default group as
its own rather than making a second (and leaves it to its maker at
``shutdown``). The mesh's axis groups (``parallel/mesh.py``) are
sub-groups of it.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import DP_AXIS, Mesh

# Offset added to the scheduler port for the rendezvous when
# BYTEPS_COORD_PORT is not set: keeps the whole port block derivable from
# DMLC_PS_ROOT_PORT (servers live at scheduler_port + server_id).
COORD_PORT_OFFSET = 512


def coordinator_address(config) -> str:
    port = config.coord_port or config.scheduler_port + COORD_PORT_OFFSET
    return f"{config.scheduler_uri}:{port}"


def ensure_initialized(config, backend: Optional[str] = None) -> bool:
    """Make the job's process group for a multi-process topology
    (idempotent): ``config.num_processes`` ranks, this one
    ``config.process_id``, meeting at ``coordinator_address(config)``.
    ``backend`` defaults to NCCL where a card is present, else gloo.

    Returns True when this process is part of an initialized
    multi-process group afterwards: every process blocks here until the
    whole set has met, as at the reference's global barrier."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if config.num_processes <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address(config)}",
        rank=config.process_id, world_size=config.num_processes,
        timeout=timedelta(seconds=300))
    return True


def process_identity() -> tuple:
    """(process_id, process_count) of the live process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_batch(mesh: Mesh, batch: torch.Tensor, axis: str = DP_AXIS,
                 dim: int = 0) -> torch.Tensor:
    """This rank's slice, along ``dim``, of a batch split over ``axis``.

    JAX assembles one global array from the processes' local data
    (``make_array_from_process_local_data``); torch has no global array,
    so each rank holds only its part, and this gives a rank that holds
    the whole batch (every rank alike) its part of it: chunk
    ``axis_index`` of ``axis_size`` equal chunks."""
    n = mesh.shape.get(axis, 1)
    if batch.shape[dim] % n:
        raise ValueError(f"batch dim {dim} of {tuple(batch.shape)} does not "
                         f"split into {n} over {axis!r}")
    return batch.chunk(n, dim)[mesh.axis_index(axis)] if n > 1 else batch


def sync_global_devices(tag: str = "byteps_tpu") -> None:
    """A barrier of every process (the reference's Postoffice::Barrier);
    ``tag`` names it in a hang's traceback only."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
