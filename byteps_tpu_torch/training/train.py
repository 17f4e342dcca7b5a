"""Train-step construction.

Port of byteps_tpu/jax/train.py:37-85 (``make_train_step``). The JAX step
is one compiled program over the mesh; here it is an eager step: forward
and backward on the local batch, then ``optimizer.step()``, whose
``DistributedOptimizer`` push_pulls the gradients before the update. The
returned loss is the mean over the ``dp`` group, like the JAX step's
``pmean``.
"""

from __future__ import annotations

from typing import Callable

import torch.distributed as dist


def make_train_step(loss_fn: Callable, optimizer):
    """``loss_fn(batch) -> scalar`` on the local batch (a closure over the
    model's parameters); ``optimizer`` a ``DistributedOptimizer``.
    Returns ``step(batch) -> loss`` (a detached scalar tensor)."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        optimizer.step()
        loss = loss.detach().clone()
        group = getattr(optimizer, "group", None)
        if group is not None and dist.get_world_size(group) > 1:
            dist.all_reduce(loss, group=group)
            loss /= dist.get_world_size(group)
        return loss

    return step
