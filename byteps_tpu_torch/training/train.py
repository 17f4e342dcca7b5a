"""Train-step construction.

Port of byteps_tpu/jax/train.py: ``make_train_step`` (:37-85) and the
device-compressed tier of ``make_ps_train_step`` (:875-895). The JAX steps
are compiled programs over the mesh; here they are eager: forward and
backward on the local batch, the gradient round, then the optimizer.
The returned loss is the mean over the ``dp`` group, like the JAX step's
``pmean``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.spans import StepSpans


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


def named_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a nested dict of tensors (or an
    ``nn.Module``'s parameters, nested at each "."), in the order a JAX
    pytree of the same dicts flattens: keys sorted at every level, the
    path joined by "/"."""
    if isinstance(params, torch.nn.Module):
        tree: Dict[str, Any] = {}
        for name, p in params.named_parameters():
            *parents, last = name.split(".")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = p
        params = tree
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out.append((prefix[:-1], node))

    walk(params, "")
    return out


def make_ps_train_step(loss_fn: Callable, optimizer, params,
                       compression: Optional[Dict[str, str]] = None,
                       min_compress_bytes: Optional[int] = None,
                       device_compress: bool = True):
    """The parameter-server train step on its device-compressed tier
    (byteps_tpu/jax/train.py:875-895):

    1. forward and backward on the local batch;
    2. the ``dp`` reduce (mean; nothing to do for a group of one);
    3. one device-compressed PS round over the named gradients
       ("grad/" + path, as the JAX step names them): compress on the
       card, fused PUSHPULL through the scheduler to the C++ server,
       decompress the aggregate on the card
       (``device_compression.DeviceCompressor``);
    4. ``optimizer.step()`` on the averaged gradients.

    ``loss_fn(batch) -> scalar`` closes over the model; ``optimizer`` is a
    plain ``torch.optim`` optimizer; ``params`` is the model's nested
    parameter dict (``Llama.params()``) or the ``nn.Module``, and names
    the gradients. ``compression``: codec kwargs, e.g.
    ``{"compressor": "dithering", "ef": "vanilla"}``. Leaves whose
    partitions are under ``min_compress_bytes`` (default
    BYTEPS_MIN_COMPRESS_BYTES) travel dense. Without a PS client (no
    servers configured) the step reduces over ``dp`` and applies.

    Returns ``step(batch) -> loss`` (a detached scalar, the dp mean).
    ``step.spans`` is a ``utils.spans.StepSpans``: set
    ``step.spans.enabled = True`` to record where each step's time goes
    (forward_backward, compress, d2h, wire, h2d, decompress, optimizer).
    ``step.device_compressor()`` is the round's ``DeviceCompressor``
    (None before the first PS round)."""
    if compression is None or device_compress is False:
        raise NotImplementedError(
            "the PS host tier (dense PS push_pull, host codecs) is not yet "
            "ported to byteps_tpu_torch: pass compression=... with "
            "device_compress=True")
    from ..core.state import get_state
    from ..ops.push_pull import psum_tree
    from .device_compression import DeviceCompressor

    named = named_leaves(params)
    names = ["grad/" + n for n, _ in named]
    tensors = [t for _, t in named]
    comp_state: Dict[str, Any] = {"client": None, "device": None}
    spans = StepSpans()

    def step(batch):
        state = get_state().require()
        spans.start(state.device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        loss = loss.detach().clone()
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in tensors]
        n = dist.get_world_size(state.group)
        if n > 1:
            grads = psum_tree(grads, state.group, average=True)
            dist.all_reduce(loss, group=state.group)
            loss /= n
        spans.mark("forward_backward")
        if state.ps_client is not None:
            client = state.ps_client
            if comp_state["client"] is not client:
                mcb = min_compress_bytes
                if mcb is None:
                    mcb = state.config.min_compress_bytes
                comp_state["device"] = DeviceCompressor(
                    client, state.config.num_workers, compression, mcb)
                comp_state["client"] = client
            grads = comp_state["device"].push_pull_leaves(
                state, names, grads, spans=spans)
        for t, g in zip(tensors, grads):
            t.grad = g
        optimizer.step()
        spans.mark("optimizer")
        return loss

    step.spans = spans
    step.device_compressor = lambda: comp_state["device"]
    return step
