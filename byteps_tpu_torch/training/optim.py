"""The optimizer step of one parameter, for the PS train step's drain,
and the hand-fused Adam step.

``fused_adam_step`` is byteps_tpu/jax/optim.py:36-79: ``(init, step)``
with every leaf's update one elementwise pass, here one launch of the
``csrc/fused_adam.cu`` kernel per leaf on a card
(``ops/fused_adam.py``).

The per-leaf apply is a port of byteps_tpu/jax/optim.py
``make_sharded_apply`` (:526) and ``_probe_separable`` (:214). The PS
step applies each leaf's update the moment its aggregate lands, so
UPDATE(k) overlaps PULL(k + 1); in PyTorch that is the optimizer step
per parameter. The step is the user's
own ``torch.optim`` optimizer's: ``LeafApply.step(p)`` runs
``optimizer.step()`` over a copy of ``p``'s param group that holds ``p``
alone, so the optimizer keeps the state (``optimizer.state[p]``) and the
hyperparameters, its ``state_dict()`` stays right for a checkpoint, and
with ``foreach`` fixed the same the update equals the one of
``optimizer.step()`` over all parameters bit for bit.

SGD, Adam and AdamW update each parameter from its own gradient and
state, and a numeric probe on small surrogate parameters confirms it for
the optimizer's settings. Any other optimizer (or a probe that fails)
gets ``None`` from ``make_leaf_apply``: the step then runs one
``optimizer.step()`` after the whole drain, the JAX package's fused
apply.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch

from ..ops.fused_adam import bias_corrections, fused_adam_leaf

# per-parameter updates: each reads only its parameter's gradient and state
SEPARABLE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW)


class LeafApply:
    """``step(p)``: the optimizer's step for parameter ``p`` alone."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        self.optimizer = optimizer
        self._where: dict = {}   # id(param) -> its group's index

    def _group(self, p: torch.Tensor) -> dict:
        groups = self.optimizer.param_groups
        gi = self._where.get(id(p))
        if gi is None or gi >= len(groups):   # a group added since
            self._where = {id(q): i for i, g in enumerate(groups)
                           for q in g["params"]}
            gi = self._where.get(id(p))
            if gi is None:
                raise KeyError("the parameter is in no param group of the "
                               "optimizer")
        return groups[gi]

    @torch.no_grad()
    def step(self, p: torch.Tensor) -> None:
        opt = self.optimizer
        groups = opt.param_groups
        opt.param_groups = [dict(self._group(p), params=[p])]
        try:
            opt.step()
        finally:
            opt.param_groups = groups


def _probe_separable(optimizer: torch.optim.Optimizer) -> bool:
    """Two steps of the optimizer's class and settings on three small
    surrogate parameters, once fused and once leaf by leaf: separable if
    the parameters agree bit for bit."""
    cls = type(optimizer)
    accepted = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in optimizer.defaults.items() if k in accepted}
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(2, 3, generator=gen) for _ in range(3)]
    grads = [[torch.randn(2, 3, generator=gen) for _ in init]
             for _ in range(2)]
    fused = [torch.nn.Parameter(x.clone()) for x in init]
    leaf = [torch.nn.Parameter(x.clone()) for x in init]
    opt_f, opt_l = cls(fused, **kw), cls(leaf, **kw)
    apply = LeafApply(opt_l)
    for gs in grads:
        for p, q, g in zip(fused, leaf, gs):
            p.grad, q.grad = g.clone(), g.clone()
        opt_f.step()
        for q in leaf:
            apply.step(q)
    return all(torch.equal(p, q) for p, q in zip(fused, leaf))


def make_leaf_apply(optimizer) -> Optional[LeafApply]:
    """A ``LeafApply`` for SGD, Adam and AdamW whose probe passes, else
    None (one ``optimizer.step()`` after the drain)."""
    if type(optimizer) not in SEPARABLE:
        return None
    try:
        separable = _probe_separable(optimizer)
    except (RuntimeError, TypeError, ValueError):
        # settings the surrogates cannot take (a CUDA-only fused step):
        # the fused apply is always right
        return None
    return LeafApply(optimizer) if separable else None


def fused_adam_step(loss_fn: Callable, lr: float = 1e-3, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8):
    """``(init, step)`` of a hand-fused Adam train step.

    ``loss_fn(params, batch) -> scalar`` over a nested dict of f32 leaves.
    ``init(params)`` gives ``{"mu": bf16 zeros, "nu": f32 zeros,
    "count": 0}`` (the JAX function's default ``mu_dtype``: a bf16 mu
    halves the first moment's traffic; nu stays f32);
    ``step(params, opt_state, batch)`` differentiates the loss, updates
    every leaf and both of its moments in place with one
    ``fused_adam_leaf`` (one kernel launch on a card), and returns
    ``(params, opt_state, loss)`` with the count advanced."""
    from .train import named_leaves

    def init(params) -> dict:
        from ..ops.push_pull import tree_map
        return {"mu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.bfloat16, device=p.device), params),
                "nu": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "count": 0}

    def step(params, opt_state: dict, batch: Any):
        leaves = [t for _, t in named_leaves(params)]
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        count = int(opt_state["count"]) + 1
        bc1, bc2 = bias_corrections(count, b1, b2)
        mus = [t for _, t in named_leaves(opt_state["mu"])]
        nus = [t for _, t in named_leaves(opt_state["nu"])]
        for p, g, m, v in zip(leaves, grads, mus, nus):
            fused_adam_leaf(p, g if g is not None else torch.zeros_like(p),
                            m, v, lr, b1, b2, eps, bc1, bc2)
        return params, dict(opt_state, count=count), loss.detach()

    return init, step
