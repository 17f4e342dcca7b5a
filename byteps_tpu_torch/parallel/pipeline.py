"""Pipeline parallelism over the ``pp`` mesh axis.

Port of byteps_tpu/parallel/pipeline.py: GPipe-style microbatching
written as collectives, one program on every stage.

- Layer parameters are stacked on a leading [L] dim (models/llama.py)
  and split over ``pp``: each of the P stages holds L / P layers.
- Each of M + P - 1 ticks (a) injects the next microbatch at stage 0,
  (b) runs the stage's layers, (c) collects a finished microbatch at the
  last stage, (d) rotates the activations one stage on with a cyclic
  ``ppermute``; the bubbles compute on data that is never collected.

As in JAX, each stage-dependent choice is a ``where`` on a condition
known per rank, not a branch: every rank runs the same operations and
so reaches the same backward collectives (the rotations' transposes, the
inverse rotation) in the same order. The backward is autograd's through
the ticks.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from .collectives import axis_index, axis_size, ppermute, psum
from .mesh import PP_AXIS


def _leading(stage_params: Any) -> int:
    while isinstance(stage_params, dict):
        stage_params = next(iter(stage_params.values()))
    return stage_params.shape[0]


def _layer(stage_params: Any, i: int) -> Any:
    if isinstance(stage_params, dict):
        return {k: _layer(v, i) for k, v in stage_params.items()}
    return stage_params[i]


def pipeline_forward(x: torch.Tensor, stage_params: Any,
                     layer_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                     *, num_microbatches: int, axis: str = PP_AXIS,
                     remat: bool = False) -> torch.Tensor:
    """Run the local batch ``x`` through all L stacked layers pipelined
    over ``axis`` (inside ``with mesh:``).

    x: [B, ...] activations, the same on every stage; B divisible by
       ``num_microbatches``.
    stage_params: a dict tree whose leaves have a leading dim of L / P
       (this stage's layers).
    layer_fn(h, p_layer) -> h: ONE layer; under ``remat`` each layer is
       recomputed in the backward (``torch.utils.checkpoint``).

    Returns [B, ...], valid ONLY on the last stage (zeros elsewhere)."""
    M = num_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    P = axis_size(axis)
    s = axis_index(axis)
    mb = B // M
    x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
    n_local = _leading(stage_params)
    first = torch.tensor(s == 0, device=x.device)
    perm = [(i, (i + 1) % P) for i in range(P)]

    def run_stage(h):
        for i in range(n_local):
            p = _layer(stage_params, i)
            if remat and torch.is_grad_enabled():
                h = checkpoint(layer_fn, h, p, use_reentrant=False)
            else:
                h = layer_fn(h, p)
        return h

    state = torch.zeros((mb,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    outs = []
    for t in range(M + P - 1):
        # (a) microbatch t in at stage 0 (clamped: what the stage takes
        # past M is never collected)
        inj = x_mb[min(t, M - 1)]
        state = torch.where(first, inj.to(state.dtype), state)
        # (b) this stage's layers
        state = run_stage(state)
        # (c) the last stage finished microbatch t - (P - 1)
        if t >= P - 1:
            outs.append(state)
        # (d) on one stage
        state = ppermute(state, axis, perm)
    out = torch.cat(outs, dim=0).to(x.dtype)
    # only the last stage collected real data: zeros elsewhere, so that a
    # psum broadcasts it without double counting
    last = torch.tensor(s == P - 1, device=x.device)
    return torch.where(last, out, torch.zeros_like(out))


def last_stage_value(v: torch.Tensor, axis: str = PP_AXIS) -> torch.Tensor:
    """Broadcast a value valid only on the last stage to every stage
    (zero elsewhere, then ``psum``).

    Gradient-exact under each stage's own backward: every stage seeds its
    replicated result with cotangent 1, which ``psum``'s transpose would
    sum into P times the gradient; the value is kept while the
    differentiable path is scaled by 1 / P."""
    P = axis_size(axis)
    s = axis_index(axis)
    last = torch.tensor(s == P - 1, device=v.device)
    summed = psum(torch.where(last, v, torch.zeros_like(v)), axis)
    if P == 1:
        return summed
    return summed / P + summed.detach() * ((P - 1) / P)


def replicated_grad_correction(grads: Any, axis: str = PP_AXIS) -> Any:
    """Sum the gradients of pp-replicated parameters (embeddings, head,
    final norm) over the stages: each stage touched them only in its own
    part of the computation, so the gradient is the sum of the parts."""
    with torch.no_grad():
        return psum(grads, axis)
