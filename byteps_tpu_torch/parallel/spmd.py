"""The train step of the GSPMD tier: the counterpart of
``jax.jit(step, in_shardings=..., out_shardings=...)`` over a mesh.

In the JAX package (``__graft_entry__.py`` ``_dryrun_dp_tp_sp``,
``_dryrun_bert_dp_tp``, ``_dryrun_fsdp``, tests/test_fsdp.py) a step of
``value_and_grad`` and the optimizer is jitted with the parameters and
the optimizer state laid out by a spec tree and the batch by a batch
spec; XLA writes every collective. ``make_spmd_train_step`` does the
same for this rank of a ``Mesh``:

- the parameters, and the user's ``torch.optim`` state beside them, stay
  in the spec layout (this rank's slices, ``sharding.place_params``);
- the batch is split by the batch spec over its data axes (``dp``, and
  ``sp`` for the sequence); leaves split over a data axis are FSDP's
  (``parallel/fsdp.py``), handed to the model as ``fsdp.Sharded``; the
  model does the tensor parallelism over the other axes itself
  (``tp_axis``);
- the loss is the global batch's. ``loss_fn(params, batch)`` gives this
  rank's loss over its slice: a scalar mean (the slices weigh alike; the
  global loss is their mean), or a pair (sum, count), whose global loss
  is the sum of the sums over the sum of the counts (BERT's
  ``sum(nll) / sum(valid)``: two ranks with different counts of masked
  labels would give another loss if their means were averaged). Each
  rank differentiates its part of the global loss, so:
- the gradient of a leaf replicated over a data axis is the sum over it
  of the ranks' parts (the mean of their mean gradients, where the
  slices weigh alike), one bucketed all-reduce an axis; a leaf split
  over it had its parts summed by FSDP's reduce-scatter or reduce in the
  backward.

Under ``sp`` the model's loss is already the ``pmean`` over the axis
(``llama.loss_fn(sp_axis=)``), whose ranks' gradients differ; summing
their parts is the ``pmean`` of the gradients that ROADMAP §C.15
prescribes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from . import fsdp
from .collectives import _all_reduce
from .mesh import Mesh
from .sharding import P, _expand, place_params


def data_axes(spec: P) -> tuple:
    """The axis names of a batch spec, major first."""
    out = []
    for e in spec:
        if e is not None:
            out += [e] if isinstance(e, str) else list(e)
    return tuple(out)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def make_spmd_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                         params: Any, mesh: Mesh, param_specs: Any,
                         batch_spec: P) -> Callable:
    """A train step over ``mesh``. ``params``: this rank's slices of the
    parameter tree by ``param_specs`` (tensors that require grad, the
    ones ``optimizer`` steps). ``step(batch)`` takes the global batch (a
    dict of tensors, alike on every rank), splits it by ``batch_spec``,
    runs ``loss_fn`` on this rank's slice inside ``with mesh:``, sums the
    gradients as the module says, steps ``optimizer``, and returns the
    global loss (the same on every rank)."""
    axes = data_axes(batch_spec)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"batch axis {a!r} is not an axis of {mesh}")
    leaves = _leaves(params)
    specs = _leaves(_expand(param_specs, params))
    # the leaves whose gradient an axis sums: those it does not split
    summed = {a: [i for i, s in enumerate(specs) if a not in data_axes(s)]
              for a in axes}

    def step(batch: dict) -> torch.Tensor:
        with mesh:
            local = place_params(batch, mesh, batch_spec)
            out = loss_fn(fsdp.view(params, param_specs, mesh, axes), local)
            total, count = out if isinstance(out, tuple) else (out, 1)
            count = torch.as_tensor(count, dtype=torch.float32,
                                    device=total.device)
            for a in axes:
                count = _all_reduce(count, mesh.group(a))
            part = total / torch.clamp(count, min=1)
            grads = list(torch.autograd.grad(part, leaves,
                                             allow_unused=True))
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]
                loss = part.detach()
                for a in axes:
                    _sum_over(grads, summed[a], mesh.group(a))
                    loss = _all_reduce(loss, mesh.group(a))
            for p, g in zip(leaves, grads):
                p.grad = g
            optimizer.step()
        return loss

    return step


def _sum_over(grads: list, which: list, group) -> None:
    """``grads[i]`` for i in ``which`` summed over ``group``, as one
    all-reduce of their concatenation."""
    if not which:
        return
    flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in which]),
                       group)
    at = 0
    for i in which:
        n = grads[i].numel()
        grads[i] = flat[at:at + n].view_as(grads[i]).to(grads[i].dtype)
        at += n
