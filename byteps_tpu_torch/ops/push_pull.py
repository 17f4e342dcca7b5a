"""push_pull over the ``dp`` process group, and across PS workers.

The JAX package sums gradients with ``lax.psum`` inside the compiled step
(ops/push_pull.py:48-66); BytePS carries the same intra-host reduction on
NCCL (SURVEY §1, L3a). Here it is ``torch.distributed.all_reduce`` on the
group that ``init`` set up: NCCL on the card, gloo on the CPU. The eager
``push_pull`` and ``broadcast`` then cross the PS workers through the
servers, as the JAX package's do.

The shard helpers (byteps_tpu/ops/push_pull.py:73-133) split a leaf over
the group for the locality-shard export: ``scatter_leaf`` reduce-scatters
the flat leaf, zero-padded to ``shard_layout``'s multiple of the group
size, so each rank holds one flat shard of the sum (or mean);
``all_gather_tree`` puts the shards back together into the leaves'
shapes.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Optional, Tuple

import numpy as np
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


def _ps_leg(state, out: torch.Tensor, name: str, average: bool,
            priority: Optional[int] = None,
            zero: bool = False) -> torch.Tensor:
    """The cross-worker half of an eager op (byteps_tpu/ops/push_pull.py
    :268-279): the dp-reduced ``out`` round-trips through the servers
    under ``name``. The group is one PS worker, so its root pushes
    (zeros, with ``zero``) and broadcasts the aggregate; the other ranks
    declare the key alike."""
    from ..core.types import host_array, host_tensor
    from ..server.client import ps_round_trip
    host, dtype = host_array(out)
    host = host.reshape(-1)
    if not state.is_root:
        state.registry.init_tensor(name, host.nbytes, dtype)
    else:
        if zero:
            host = np.zeros_like(host)
        agg = ps_round_trip(state, name, host, average, priority=priority,
                            dtype=dtype)
        out = host_tensor(agg, dtype).reshape(out.shape).to(out.device)
    if state.local_size > 1:
        dist.broadcast(out, src=0, group=state.group)
    return out


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None,
              priority: Optional[int] = None) -> torch.Tensor:
    """Eager push_pull of one tensor, as a new tensor
    (byteps_tpu/ops/push_pull.py:203-285): its mean (or sum) over the
    ``dp`` group, then, with a PS client, over the workers: the
    dp-reduced value round-trips through the servers under ``name``,
    which is required there. A zero-element tensor returns zeros and
    touches nothing; a named one declares its key."""
    state = get_state().require()
    if tensor.numel() == 0:
        return torch.zeros_like(tensor)
    if name is not None and state.registry is not None:
        from ..core.types import DataType
        state.registry.init_tensor(name, tensor.numel()
                                   * tensor.element_size(),
                                   DataType.of_torch(tensor.dtype))
    out = all_reduce_(tensor.clone(), average=average)
    if state.ps_client is not None:
        if name is None:
            raise ValueError(
                "push_pull over the PS requires a tensor name (stable keys "
                "must match across workers; operations.cc:420-427)")
        out = _ps_leg(state, out, name, average, priority)
    return out


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """The root's copy of ``tensor``, as a new tensor
    (byteps_tpu/ops/push_pull.py:288-338). ``root_rank`` is global: rank
    ``root_rank % local_size`` of the ``dp`` group broadcasts, and with
    several PS workers worker ``root_rank // local_size`` wins, through
    a sum of its value and the others' zeros under ``"bcast/" + name``
    (``name`` required there)."""
    state = get_state().require()
    out = tensor.clone()
    dist.broadcast(out, src=root_rank % state.local_size, group=state.group)
    if state.ps_client is not None and state.config.num_workers > 1:
        if name is None:
            raise ValueError("broadcast over the PS requires a tensor name")
        root_worker = root_rank // state.local_size
        out = _ps_leg(state, out, "bcast/" + name, average=False,
                      zero=state.config.worker_id != root_worker)
    return out


def broadcast_pickled(payload: bytes, bcast: Callable, keys: Tuple[str, str],
                      len_dtype) -> Any:
    """The root's object, unpickled, from two rounds of ``bcast(array,
    key)``, which returns the root's array: the pickle's length as
    ``len_dtype`` under ``keys[0]`` first, since each worker's pickle may
    differ in size and the PS needs equal buffers under one key, then
    ``payload`` zero-padded (or cut) to the root's length under
    ``keys[1]``. The JAX adapter sends the length as int32
    (byteps_tpu/jax/__init__.py:157-181), the PyTorch one as int64
    (byteps_tpu/torch/__init__.py:419-459)."""
    n = bcast(np.array([len(payload)], len_dtype), keys[0])
    total = int(n.reshape(-1)[0])
    buf = np.zeros(total, np.uint8)
    take = min(len(payload), total)
    buf[:take] = np.frombuffer(payload, np.uint8)[:take]
    return pickle.loads(
        np.asarray(bcast(buf, keys[1])).astype(np.uint8).tobytes())


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
