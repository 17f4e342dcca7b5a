"""The training adapter: ``DistributedOptimizer``,
``broadcast_parameters`` and ``broadcast_object``, and the train steps
(``make_train_step`` over the ``dp`` group, ``make_zero_train_step``
with the optimizer state sharded over it (ZeRO-1), ``make_ps_train_step``
through the parameter server, ``make_async_ps_train_step`` with
asynchronous servers), and ``fused_adam_step``, the hand-fused Adam
step.

Port of byteps_tpu/jax/__init__.py:49-96 (``distributed_optimizer``,
``optax.chain(comm, tx)``) onto a ``torch.optim`` optimizer: ``step()``
first reduces every ``p.grad`` over the ``dp`` group, compressed when a
``compression`` dict is given, then runs the inner optimizer's step.

``torch.optim.Adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)`` is the update
of ``optax.adam(1e-3)`` (eps outside the square root, bias-corrected
moments) up to rounding.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.state import get_state
from ..ops.compression import CompressionTransform
from ..ops.push_pull import all_reduce_, broadcast, broadcast_pickled
from .optim import fused_adam_step
from .train import (ZeroState, init_zero_state, make_async_ps_train_step,
                    make_ps_train_step, make_train_step,
                    make_zero_train_step, named_leaves)

__all__ = ["DistributedOptimizer", "distributed_optimizer",
           "broadcast_parameters", "broadcast_object", "make_train_step",
           "make_ps_train_step", "make_async_ps_train_step",
           "make_zero_train_step", "init_zero_state", "ZeroState",
           "fused_adam_step"]


class DistributedOptimizer:
    """Wrap ``optimizer`` so its gradients are push_pulled across the
    ``dp`` group before each update (BytePS torch/__init__.py:37-216).

    ``compression``: string kwargs for the codec registry, e.g.
    ``{"compressor": "onebit", "ef": "vanilla"}``, with onebit, topk,
    randomk or dithering (``compressed_psum_tree``); EF and momentum state
    live in ``self.compression`` (one entry per parameter, in the order of
    the optimizer's param groups). Leaves under ``min_compress_bytes``
    (default BYTEPS_MIN_COMPRESS_BYTES) take the plain all-reduce.
    ``lr_schedule``: step -> lr, for the EF residual rescale. Plain
    reductions run in place on ``p.grad``; compressed ones replace it.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 compression: Optional[Dict[str, str]] = None,
                 average: bool = True,
                 min_compress_bytes: Optional[int] = None,
                 lr_schedule=None, group=None):
        self.optimizer = optimizer
        self.group = group if group is not None else \
            get_state().require().group
        self.average = average
        self.params: List[torch.Tensor] = [
            p for g in optimizer.param_groups for p in g["params"]]
        self.compression = None
        if compression is not None:
            self.compression = CompressionTransform(
                self.params, compression, group=self.group, average=average,
                min_compress_bytes=min_compress_bytes,
                lr_schedule=lr_schedule)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def synchronize(self) -> None:
        """Reduce every gradient over the group (the comm half of step).
        A parameter without a gradient reduces zeros, so every rank runs
        the same collectives."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.compression is None:
            for p in self.params:
                all_reduce_(p.grad, self.group, self.average)
            return
        reduced = self.compression.update([p.grad for p in self.params])
        for p, g in zip(self.params, reduced):
            p.grad = g

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)


# the functional name of the JAX adapter
distributed_optimizer = DistributedOptimizer


@torch.no_grad()
def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Make every process's parameters equal to the root's, in place
    (byteps_tpu/jax/__init__.py:138-154). ``params``: a nested dict of
    tensors, a ``state_dict``, an ``nn.Module``, ``named_parameters()``
    pairs or an iterable of tensors. Each leaf is broadcast
    (``ops.push_pull.broadcast``) under ``"param/<path>"``, its path as
    the JAX adapter flattens the same tree ("/"-joined keys, sorted; list
    indices), so with several PS workers the root worker's copy wins on
    every worker of either package."""
    if isinstance(params, (dict, torch.nn.Module)):
        leaves = named_leaves(params)
    else:
        items = list(params)
        if items and isinstance(items[0], tuple):
            leaves = named_leaves(dict(items))
        else:
            leaves = named_leaves(items)
    for path, p in leaves:
        p.data.copy_(broadcast(p.data, root_rank=root_rank,
                               name="param/" + path))


def broadcast_object(obj: Any, root_rank: int = 0, name: str = "obj") -> Any:
    """The root's copy of a picklable object
    (byteps_tpu/jax/__init__.py:157-181): its pickle's length (int32)
    under ``"bcastobj/" + name + "/len"``, then the payload zero-padded
    to the root's length under ``".../payload"`` (``broadcast_pickled``),
    each through ``ops.push_pull.broadcast``."""
    state = get_state().require()
    dev = state.device if dist.get_backend(state.group) == "nccl" \
        else torch.device("cpu")

    def bcast(a: np.ndarray, key: str) -> np.ndarray:
        return broadcast(torch.from_numpy(a).to(dev), root_rank=root_rank,
                         name=key).cpu().numpy()

    nm = "bcastobj/" + name
    return broadcast_pickled(pickle.dumps(obj), bcast,
                             (nm + "/len", nm + "/payload"), np.int32)
