"""The optimizer step of one parameter, for the PS train step's drain.

Port of byteps_tpu/jax/optim.py ``make_sharded_apply`` (:526) and
``_probe_separable`` (:214). The PS step applies each leaf's update the
moment its aggregate lands, so UPDATE(k) overlaps PULL(k + 1); in
PyTorch that is the optimizer step per parameter. The step is the user's
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
from typing import Optional

import torch

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
