"""push_pull over the ``dp`` process group.

The JAX package sums gradients with ``lax.psum`` inside the compiled step
(ops/push_pull.py:48-66); BytePS carries the same intra-host reduction on
NCCL (SURVEY §1, L3a). Here it is ``torch.distributed.all_reduce`` on the
group that ``init`` set up: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core.state import get_state


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the tensors of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _average_(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return t.div_(n)
    # integers keep their dtype and truncate toward zero, like the
    # reference's div_(size) (torch/ops.cc:78-90); floor division would
    # skew every negative element by one
    return t.div_(n, rounding_mode="trunc")


def all_reduce_(t: torch.Tensor, group=None, average: bool = True
                ) -> torch.Tensor:
    """Sum (or mean) ``t`` across the group, in place."""
    group = group if group is not None else get_state().require().group
    dist.all_reduce(t, group=group)
    if average:
        _average_(t, dist.get_world_size(group))
    return t


def psum_tree(tree: Any, group=None, average: bool = True) -> Any:
    """Sum (or mean) every tensor of ``tree`` across the ``dp`` group and
    return new tensors; the inputs are left as they are."""
    return tree_map(lambda t: all_reduce_(t.clone(), group, average), tree)


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: str = None) -> torch.Tensor:
    """Eager push_pull of one tensor: its mean (or sum) over the ``dp``
    group, as a new tensor. ``name`` is accepted for the reference's
    signature; one process group needs no key."""
    del name
    return all_reduce_(tensor.clone(), average=average)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: str = None) -> torch.Tensor:
    """The root rank's copy of ``tensor``, as a new tensor."""
    del name
    group = get_state().require().group
    out = tensor.clone()
    dist.broadcast(out, src=root_rank, group=group)
    return out
