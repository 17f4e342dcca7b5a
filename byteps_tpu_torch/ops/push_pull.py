"""push_pull over the ``dp`` process group.

The JAX package sums gradients with ``lax.psum`` inside the compiled step
(ops/push_pull.py:48-66); BytePS carries the same intra-host reduction on
NCCL (SURVEY §1, L3a). Here it is ``torch.distributed.all_reduce`` on the
group that ``init`` set up: NCCL on the card, gloo on the CPU.

The shard helpers (byteps_tpu/ops/push_pull.py:73-133) split a leaf over
the group for the locality-shard export: ``scatter_leaf`` reduce-scatters
the flat leaf, zero-padded to ``shard_layout``'s multiple of the group
size, so each rank holds one flat shard of the sum (or mean);
``all_gather_tree`` puts the shards back together into the leaves'
shapes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

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


def shard_layout(size: int, num_shards: int) -> Tuple[int, int]:
    """(shard_len, pad) with shard_len * num_shards == size + pad: the
    padding of ``scatter_leaf``, which the host side's per-shard keys
    follow (byteps_tpu/ops/push_pull.py:101)."""
    shard_len = (size + num_shards - 1) // num_shards
    return shard_len, shard_len * num_shards - size


def padded_flat(t: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``t`` flattened (contiguous) and zero-padded to ``shard_layout``'s
    length."""
    flat = t.reshape(-1)
    _, pad = shard_layout(flat.numel(), num_shards)
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def scatter_leaf(g: torch.Tensor, group=None,
                 average: bool = True) -> torch.Tensor:
    """Reduce-scatter one leaf over the group: this rank's flat shard of
    the sum (or mean; integers truncate, as ``_average_``)."""
    group = group if group is not None else get_state().require().group
    n = dist.get_world_size(group)
    flat = padded_flat(g, n)
    out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return _average_(out, n) if average else out


def reduce_scatter_tree(tree: Any, group=None, average: bool = True) -> Any:
    """``scatter_leaf`` of every leaf: each rank holds a flat 1/N shard
    of each summed (or averaged) leaf."""
    return tree_map(lambda g: scatter_leaf(g, group, average), tree)


def gather_leaf(shard: torch.Tensor, like, group=None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-gather the flat shards of one leaf into the shape and dtype of
    ``like`` (a tensor, or anything with ``shape`` and ``dtype``), the
    padding dropped. ``out``: a buffer of N shards to gather into."""
    group = group if group is not None else get_state().require().group
    n = dist.get_world_size(group)
    if out is None:
        out = torch.empty(n * shard.numel(), dtype=shard.dtype,
                          device=shard.device)
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    size = 1
    for d in like.shape:
        size *= d
    return out[:size].reshape(like.shape).to(like.dtype)


def all_gather_tree(shard_tree: Any, shapes: Any, group=None) -> Any:
    """The inverse of ``reduce_scatter_tree``: gather every leaf's shards
    and restore the shape and dtype of the matching leaf of ``shapes``."""
    if isinstance(shard_tree, dict):
        return {k: all_gather_tree(v, shapes[k], group)
                for k, v in shard_tree.items()}
    if isinstance(shard_tree, (list, tuple)):
        return type(shard_tree)(all_gather_tree(v, s, group)
                                for v, s in zip(shard_tree, shapes))
    return gather_leaf(shard_tree, shapes, group)
