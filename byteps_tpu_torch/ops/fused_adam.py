"""The fused Adam update of one leaf: the CUDA kernel and its plain twin.

``fused_adam_leaf`` updates a parameter and its two moments in place with
one launch of ``csrc/fused_adam.cu`` for CUDA tensors, or through
``fused_adam_leaf_plain`` (separate torch ops) for CPU tensors; anything
else raises, and there is no fallback from one to the other.
``fused_adam_leaf.launches`` counts kernel launches.

Both round as the jitted JAX step on the CPU does
(byteps_tpu/jax/optim.py:36-79 through XLA's CPU backend, which contracts
two of its products into FMAs):

    m2  = fma(1 - b1, g, b1 * m)
    v2  = fma(b2, v, ((1 - b2) * g) * g)
    new = p - ((m2 / bc1) * lr) / (sqrt(v2 / bc2) + eps)

with every scalar an f32 (``1 - b1`` rounded from the float's double, as a
Python float becomes a weakly typed f32 in JAX). ``bias_corrections``
gives bc1 and bc2 once a step: ``1 - b ** count`` with the power rounded
once to f32. XLA's CPU power is not correctly rounded; its bc2 differs by
one ulp at 2 counts of the first 100,000 (ROADMAP §C.14).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..native import build
from .compression.kernels import fma_f32_plain, sqrt_f32

_VP = ctypes.c_void_p


def _lib():
    lib = build.load("fused_adam")
    if not getattr(lib, "_bps_typed", False):
        lib.bps_fused_adam.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_longlong,
                                       *([ctypes.c_float] * 8), _VP]
        lib.bps_fused_adam.restype = ctypes.c_int
        lib._bps_typed = True
    return lib


def bias_corrections(count: int, b1: float, b2: float) -> Tuple[float, float]:
    """(1 - b1 ** count, 1 - b2 ** count) in f32, the power of the f32
    betas rounded once to f32."""
    f32 = np.float32

    def bc(b):
        return float(f32(1) - f32(np.float64(f32(b)) ** int(count)))

    return bc(b1), bc(b2)


def _scalars(lr, b1, b2, eps) -> Tuple[float, ...]:
    """lr, b1, 1 - b1, b2, 1 - b2, eps as the f32 values JAX folds in."""
    f32 = np.float32
    return tuple(float(f32(x)) for x in (lr, b1, 1.0 - b1, b2, 1.0 - b2,
                                         eps))


@torch.no_grad()
def fused_adam_leaf_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, lr: float, b1: float, b2: float,
                          eps: float, bc1: float, bc2: float) -> None:
    """The update in place, one torch op a step of the arithmetic: f32
    products, quotients and sums round once each, the two FMAs once
    (``fma_f32_plain``), the square root correctly (``sqrt_f32``)."""
    lr_, b1_, omb1, b2_, omb2, eps_ = (
        torch.tensor(x, dtype=torch.float32, device=p.device)
        for x in _scalars(lr, b1, b2, eps))
    bc1_, bc2_ = (torch.tensor(float(np.float32(x)), dtype=torch.float32,
                               device=p.device) for x in (bc1, bc2))
    m2 = fma_f32_plain(omb1, g, b1_ * m.to(torch.float32))
    v2 = fma_f32_plain(b2_, v, (omb2 * g) * g)
    num = (m2 / bc1_) * lr_
    den = sqrt_f32(v2 / bc2_) + eps_
    p.sub_(num / den)
    m.copy_(m2)
    v.copy_(v2)


def _check(p, g, m, v) -> None:
    if not (p.dtype == g.dtype == v.dtype == torch.float32) or \
            m.dtype != torch.bfloat16:
        raise TypeError(f"fused_adam_leaf: p, g and v must be f32 and m "
                        f"bf16, got {p.dtype}, {g.dtype}, {v.dtype}, "
                        f"{m.dtype}")
    for t, name in ((g, "g"), (m, "m"), (v, "v")):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_adam_leaf: {name} {tuple(t.shape)} on "
                             f"{t.device}, p {tuple(p.shape)} on "
                             f"{p.device}")


@torch.no_grad()
def fused_adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, bc1: float, bc2: float) -> None:
    """One Adam update of a leaf in place: ``p``, ``g`` and ``v`` f32,
    ``m`` bf16, all of one shape on one device; the kernel on a card (one
    launch; p, m and v contiguous), the twin on the CPU."""
    _check(p, g, m, v)
    if p.device.type == "cpu":
        fused_adam_leaf_plain(p, g, m, v, lr, b1, b2, eps, bc1, bc2)
        return
    if p.device.type != "cuda":
        raise RuntimeError(f"fused_adam_leaf: unsupported device {p.device}")
    for t, name in ((p, "p"), (m, "m"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"fused_adam_leaf: {name} must be contiguous "
                             f"(it is updated in place)")
    g = g.contiguous()
    lib = _lib()
    with build.on_device(p.device) as stream:
        fused_adam_leaf.launches += 1
        build.check(lib, lib.bps_fused_adam(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            p.numel(), *_scalars(lr, b1, b2, eps), float(np.float32(bc1)),
            float(np.float32(bc2)), stream), "fused_adam")


fused_adam_leaf.launches = 0
