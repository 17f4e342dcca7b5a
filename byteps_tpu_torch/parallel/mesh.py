"""A named mesh of processes: each axis of it a ``torch.distributed``
process group.

Port of byteps_tpu/parallel/mesh.py. In JAX a ``Mesh`` lays devices out
on named axes, and ``shard_map`` binds those names for the collectives
inside it. Here one process drives one card (or, on a machine with one
card, several processes share it), so the mesh lays the job's ranks out
on the named axes, and every axis of it is, for this rank, the process
group of the ranks that differ from it along that axis alone.

Axis conventions, as in the JAX package:

- ``dp``: data parallel (the gradient push_pull axis; BytePS's axis)
- ``tp``: tensor parallel (Megatron-style within attention and MLP)
- ``sp``: sequence parallel (ring attention, Ulysses)
- ``pp``: pipeline stages
- ``ep``: expert parallel (MoE)

How an axis name binds: ``with mesh:`` makes the mesh the active one
(``active_mesh``) until the block ends, which is what ``shard_map`` does
for its body. The collectives (``parallel/collectives.py``) and the
models' ``sp_axis``, ``pp_axis``, ``ep_axis`` and ``axis`` arguments
keep the JAX names and resolve a name through the active mesh to this
rank's group for that axis (``Mesh.group``) and its place on it
(``Mesh.axis_index``). The active mesh is one for the process, not for
the thread: autograd runs the backward, and a checkpoint's recompute, on
threads of its own, and they resolve the same names.

Why a class of its own and not ``torch.distributed.device_mesh.DeviceMesh``:
a DeviceMesh is bound to a device type, on "cuda" may choose the
process's card as ``rank % cards`` and gives its sub-groups the device
type's backend, and its internals differ between torch releases. Two
ranks on one card over gloo (the one-card machine's transport) is
outside what it documents, and a machine without a card cannot try it.
The collectives here need only each axis's group and the rank's
coordinate on it, which this class gives alike on the CPU and the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"
PP_AXIS = "pp"
EP_AXIS = "ep"

_ACTIVE: List["Mesh"] = []


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The axis sizes of a mesh over ``n`` ranks: ``axes`` in
    major-to-minor order (default: every rank on ``dp``), one size of -1
    taking what the others leave; a ValueError when they do not multiply
    to ``n``."""
    if not axes:
        return {DP_AXIS: n}
    axes = dict(axes)
    known, wild = 1, None
    for name, size in axes.items():
        if size == -1:
            wild = name
        else:
            known *= size
    if wild is not None:
        axes[wild] = n // known
        known *= axes[wild]
    if known != n:
        raise ValueError(f"mesh axes {axes} do not multiply to {n} devices")
    return axes


class Mesh:
    """Ranks on named axes. ``ranks`` is the array of global ranks in the
    axes' shape; ``shape`` maps each name to its size. Built by
    ``make_mesh``, which makes the process groups: every rank of the job
    must build the same mesh, in the same order as any other group."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.ranks == self.rank)
        self.coords = dict(zip(self.axis_names, where[0])) if len(where) \
            else None
        world = dist.get_world_size() if dist.is_initialized() else 1
        self._groups: Dict[str, object] = {}
        for ax, name in enumerate(self.axis_names):
            # one group per line of the mesh along this axis, made by
            # every rank; each rank keeps the line it lies on
            lines = np.moveaxis(self.ranks, ax, -1).reshape(
                -1, self.ranks.shape[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                if ranks != sorted(ranks):
                    # a group numbers its ranks in increasing order; the
                    # collectives take that number for the coordinate
                    raise ValueError(f"mesh {self.shape}: the ranks along "
                                     f"axis {name!r} must increase, got "
                                     f"{ranks}")
                group = dist.group.WORLD if ranks == list(range(world)) \
                    else dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[name] = group

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        try:
            return self._groups[axis]
        except KeyError:
            raise ValueError(f"axis {axis!r} is not an axis of this mesh "
                             f"{self.shape} (or this rank is not on it)"
                             ) from None

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.coords is None or axis not in self.coords:
            raise ValueError(f"axis {axis!r} is not an axis of this mesh "
                             f"{self.shape} (or this rank is not on it)")
        return int(self.coords[axis])

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a Mesh. Default: every rank on the ``dp`` axis.

    ``axes`` maps axis name -> size, in major-to-minor order, e.g.
    ``{"dp": 4, "tp": 2}``. One axis may be -1 to absorb the remainder.
    ``devices`` are the global ranks to lay out, one process per device
    (default: every rank of the job, in order). The process groups are
    made here, so every rank calls it alike."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    devices = [int(d) for d in devices]
    axes = resolve_axes(axes, len(devices))
    return Mesh(np.array(devices).reshape(tuple(axes.values())),
                tuple(axes))


def active_mesh() -> Mesh:
    """The mesh of the innermost ``with mesh:`` block."""
    if not _ACTIVE:
        raise RuntimeError("no active mesh: run collectives and sharded "
                           "models inside `with mesh:`")
    return _ACTIVE[-1]


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)
