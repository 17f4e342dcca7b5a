"""FSDP (ZeRO-3): the parameters split over the data axis as
``sharding.fsdp_param_specs`` lays them out, each materialized where the
model uses it.

The GSPMD tier of byteps_tpu/parallel/sharding.py (``fsdp_param_specs``,
:111-148): there XLA writes the per-layer gathers and the gradients'
reduce-scatters from the layout. Here the parameters, and the user's
``torch.optim`` state beside them, live as this rank's slice
(``sharding.mirror_opt_specs`` names the state's specs), and a model
reads a leaf through ``whole`` or ``layer``:

- ``whole(leaf)``: the leaf put together, an all-gather along its split
  dim; the gradient reduce-scattered backward (each rank sums the ranks'
  gradients of its own slice);
- ``layer(leaf, l)``: layer ``l`` of a leaf stacked on a leading layer
  dim. Where that dim is the split one, layer ``l`` lives whole on one
  rank (Llama ``small()``'s 12 layers over dp = 2: 6 a rank), so the
  gather is a broadcast from that rank and the backward a reduce to it.
  Where ``fsdp_param_specs`` fell to another dim (``tiny()``'s 2 layers
  over dp = 4), the gather is an all-gather of layer ``l``'s slices and
  the backward a reduce-scatter.

Llama calls ``layer`` inside each block's checkpoint, so under
``cfg.remat`` a block's leaves are gathered just before it, freed after
it, and gathered again in the backward's recompute. A leaf that is a
plain tensor (replicated over the axis, or no FSDP at all) passes
through both unchanged.

The arithmetic is that of a replicated step on the global batch: each
rank's loss is its part of the global one (``spmd.py``), and the
backward's reduces sum the ranks' gradients of every split leaf.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch

from .collectives import all_gather_dim, axis_index, broadcast
from .sharding import _expand, _tree_map


class Sharded:
    """A leaf split over the mesh axis ``axis`` along ``dim``: ``local``
    is this rank's slice (the tensor the optimizer steps), ``shape`` the
    whole leaf's, ``n`` the axis size."""

    def __init__(self, local: torch.Tensor, dim: int, axis: str, n: int):
        self.local, self.dim, self.axis = local, dim, axis
        shape = list(local.shape)
        shape[dim] *= n
        self.shape = torch.Size(shape)

    def whole(self) -> torch.Tensor:
        return all_gather_dim(self.local, self.axis, self.dim)

    def layer(self, l: int) -> torch.Tensor:
        if self.dim:
            return all_gather_dim(self.local[l], self.axis, self.dim - 1)
        per = self.local.shape[0]
        root, j = divmod(l, per)
        # the other ranks hand a slice of the same shape, which the
        # broadcast reads only for its shape and gives no gradient
        mine = axis_index(self.axis) == root
        return broadcast(self.local[j if mine else 0], self.axis, root)


def whole(leaf: Any) -> torch.Tensor:
    """The whole of ``leaf`` (a ``Sharded`` gathered, a tensor as is)."""
    return leaf.whole() if isinstance(leaf, Sharded) else leaf


def layer(leaf: Any, l: int) -> torch.Tensor:
    """Layer ``l`` of a leaf stacked on its leading dim."""
    return leaf.layer(l) if isinstance(leaf, Sharded) else leaf[l]


def view(params: Any, specs: Any, mesh, axes: Iterable[str]) -> Any:
    """``params`` (this rank's slices, ``sharding.place_params``) with
    every leaf that ``specs`` splits over one of ``axes`` as a
    ``Sharded``; the others as they are. A leaf split over two of them
    raises."""
    axes = tuple(axes)

    def leaf(x, spec):
        hits = [(d, e) for d, e in enumerate(spec) for a in axes
                if a == e or (isinstance(e, tuple) and a in e)]
        if not hits:
            return x
        if len(hits) > 1 or not isinstance(hits[0][1], str):
            raise ValueError(f"FSDP takes a leaf split over one data axis "
                             f"on a dim of its own, not {spec}")
        d, a = hits[0]
        return Sharded(x, d, a, mesh.shape[a])

    return _tree_map(leaf, params, _expand(specs, params))

