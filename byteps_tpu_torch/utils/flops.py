"""The FLOP count of the ledger's cost model.

``count`` runs a function under ``FlopCount``, a ``TorchDispatchMode``
that adds up, for each dispatched op, the FLOPs of
``torch.utils.flop_counter.FlopCounterMode``'s formula for it (its
``flop_registry``: the matrix products, convolutions and attention
kernels, forward and backward). It does not take ``FlopCounterMode``'s
route of decomposing the ops its registry lacks: a decomposed
``silu_backward`` rounds otherwise, and the step it counts would no
longer be the step a replay or the JAX package computes, bit for bit.

A hand-written kernel launched through ctypes (the flash forward of
``ops/flash_attention.py``) dispatches nothing, so its wrapper reports
the FLOPs it computes (``report``); and where the wrapper runs the
kernel's plain twin on a CPU tensor, the twin's products are taken back
out (``counted_as``), so that a count is the same on the card and on the
CPU.

A count is process-wide while it runs (the dispatch mode follows the
backward onto autograd's threads, and a kernel may launch there); one
count runs at a time.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["FlopCount", "count", "report", "counted_as"]

_mu = threading.Lock()
_active: Optional["FlopCount"] = None   # guarded-by: _mu


class FlopCount(TorchDispatchMode):
    """Adds each dispatched op's FLOPs, by FlopCounterMode's formulas,
    into ``total``; the ops run as they would without it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self._mu = threading.Lock()
        self.total = 0.0                     # guarded-by: _mu
        self.failed = None       # an op whose formula raised, if any

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            try:
                n = formula(*args, **kwargs, out_val=out)
            except Exception:  # noqa: BLE001 - never fail the op counted
                self.failed = func
                n = 0
            with self._mu:
                self.total += n
        return out

    def add(self, flops: float) -> None:
        with self._mu:
            self.total += flops

    def read(self) -> float:
        with self._mu:
            return self.total


def count(fn, *args, **kwargs) -> tuple:
    """``(fn's result, its FLOPs, counted)``: ``fn`` runs once under a
    ``FlopCount``, with the kernels' reports added; the FLOPs are None
    when a formula failed on one of its ops. While another count runs
    (another thread's step), ``fn`` runs uncounted: (result, None,
    False)."""
    global _active
    mode = FlopCount()
    with _mu:
        busy = _active is not None
        if not busy:
            _active = mode
    if busy:
        return fn(*args, **kwargs), None, False
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        with _mu:
            _active = None
    return out, None if mode.failed is not None else mode.read(), True


def report(flops: float) -> None:
    """A kernel's FLOPs, counted if a count runs (a flag check if not)."""
    mode = _active  # bps-lint: disable=guarded-by
    if mode is not None:
        mode.add(float(flops))


@contextlib.contextmanager
def counted_as(flops: float):
    """The block (a kernel's plain twin) counts as ``flops``, whatever
    products it dispatches."""
    mode = _active  # bps-lint: disable=guarded-by
    if mode is None:
        yield
        return
    before = mode.read()
    try:
        yield
    finally:
        mode.add(float(flops) - (mode.read() - before))
