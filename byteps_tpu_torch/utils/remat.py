"""Remat policies: the names of ``jax.checkpoint_policies`` on PyTorch's
selective activation checkpointing.

Port of the ``remat_policy`` of byteps_tpu/models/llama.py (:40-45,
:304-311), which hands ``getattr(jax.checkpoint_policies, name)`` to
``jax.checkpoint``. Here a block runs under the non-reentrant
``torch.utils.checkpoint.checkpoint``; a policy that saves some ops'
outputs goes in as its ``context_fn`` (``create_selective_checkpoint_
contexts``), and every other op of the block is recomputed in the
backward:

- ``None`` and ``"nothing_saveable"``: nothing saved, the whole block
  recomputed (the plain checkpoint);
- ``"everything_saveable"``: every output autograd needs is kept, which
  is the block without a checkpoint;
- ``"dots_saveable"``: the outputs of the matrix products, ``mm``,
  ``addmm``, ``bmm`` and ``baddbmm``;
- ``"dots_with_no_batch_dims_saveable"``: ``mm`` and ``addmm`` alone.
  ``x @ W`` with a 3-D ``x`` and a 2-D ``W`` lowers to ``mm``, so the
  projections are saved; the attention's products carry batch dimensions
  (``bmm``) and are recomputed, as XLA's policy recomputes its batched
  ``dot_general``.

A kernel launched through ctypes inside an ``autograd.Function`` (the
flash forward) is invisible to the policy: it sees the ``empty`` of the
kernel's output, which no policy saves, so the recompute allocates a
fresh buffer and launches the kernel again.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
_SAVED = {
    "dots_saveable": frozenset((_aten.mm, _aten.addmm, _aten.bmm,
                                _aten.baddbmm)),
    "dots_with_no_batch_dims_saveable": frozenset((_aten.mm, _aten.addmm)),
}
POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable")


def check_policy(name: Optional[str]) -> None:
    """Raise a ValueError for a name that is not None or one of
    ``POLICIES``."""
    if name is not None and name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; supported: None, "
                         + ", ".join(repr(p) for p in POLICIES))


def _policy_fn(saved: frozenset):
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def remat_call(fn: Callable, *args, policy: Optional[str] = None):
    """``fn(*args)`` under the remat policy ``policy``."""
    check_policy(policy)
    if policy == "everything_saveable":
        return fn(*args)
    if policy is None or policy == "nothing_saveable":
        return checkpoint(fn, *args, use_reentrant=False)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _policy_fn(_SAVED[policy]))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
