"""Gradient-compression codecs over flat f32 tensors.

Port of byteps_tpu/ops/compression/codecs.py: onebit, topk, randomk and
dithering. A codec implements ``compress(x, step) -> payload`` and
``decompress(payload) -> x_hat``; ``wire_bytes`` is the payload size.
Randomk and dithering draw from the counter stream of ``rng.py`` seeded
by (seed, step): the step is the compression round, and the server
re-draws randomk's indices from the same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import rng
from .kernels import (
    dithering_dequantize, dithering_levels, n_words, onebit_pack,
    onebit_unpack, randomk_indices, sqrt_f32, xla_mean, xla_sum,
)


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base: identity codec."""

    size: int  # number of f32 elements of the uncompressed flat tensor

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        return {"raw": x}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        return payload["raw"]

    def residual(self, x: torch.Tensor,
                 payload: Dict[str, Any]) -> torch.Tensor:
        """The error-feedback residual x - decompress(payload); ``x`` is
        the caller's to reuse."""
        return x - self.decompress(payload)

    def wire_bytes(self) -> int:
        return self.size * 4


@dataclasses.dataclass(frozen=True)
class OnebitCodec(Codec):
    """signSGD with optional L1-mean scaling (BytePS onebit.cc:34-66).

    payload: ``bits`` int32 [ceil(n/32)] in the portable layout of the JAX
    codec's plain path (codecs.py:93-96) and ``scale`` f32 [] (1.0 when
    unscaled). ``decompress`` also takes a gathered payload, bits
    [R, ceil(n/32)] and scale [R], and returns [R, n]."""

    scaled: bool = True

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        # the L1 mean in XLA's summation order (the JAX codec leaves it to
        # XLA), so the scale is the JAX package's bit for bit; |x| is taken
        # as the sum reads x
        scale = xla_mean(x, absolute=True) if self.scaled else \
            torch.ones((), dtype=torch.float32, device=x.device)
        return {"bits": onebit_pack(x), "scale": scale.to(torch.float32)}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        return onebit_unpack(payload["bits"], payload["scale"], self.size)

    def wire_bytes(self) -> int:
        return n_words(self.size) * 4 + 4


def resolve_k(k_param: float, size: int) -> int:
    """k as an absolute count (>= 1) or a fraction (< 1), like
    HyperParamFinder's compressor_k handling (topk.cc:24-43)."""
    if k_param >= 1:
        k = int(k_param)
    else:
        k = max(1, int(size * k_param))
    return min(k, size)


def topk_select(x: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [k]: the indices of the ``k`` largest |x|, by (|x|
    descending, index ascending), in that order: ``lax.top_k``'s order,
    lower index first among equal values (x and -x tie too).
    ``torch.topk`` promises no order among ties, so it only finds the
    k-th largest |x|, t: every |x| > t is taken, then the elements equal
    to t in index order until there are k, and a stable sort by |x|
    descending orders them."""
    a = x.abs()
    n = a.numel()
    if k >= n:
        sel = torch.arange(n, device=x.device)
    else:
        t = torch.topk(a, k, sorted=False).values.min()
        gt = a > t
        eq = a == t
        need = k - gt.sum()
        sel = torch.nonzero(gt | (eq & (torch.cumsum(eq, 0) <= need))
                            ).reshape(-1)               # ascending index
    order = torch.sort(a[sel], descending=True, stable=True).indices
    return sel[order]


@dataclasses.dataclass(frozen=True)
class TopkCodec(Codec):
    """The k largest |x| as (index, value) pairs (topk.cc:24-43).

    The JAX codec selects with ``lax.top_k``, XLA's sort unit on the TPU;
    no Pallas kernel backs it, so the port selects with ``topk_select``
    (a ``torch.topk`` threshold and a stable sort), which gives
    ``lax.top_k``'s indices and order on ties bit for bit.
    ``approx=True`` is the TPU's ApproxTopK there (recall about 0.95);
    the exact selection meets that contract, so the flag is accepted and
    the selection stays exact.
    payload: ``indices`` int32 [k] (|x| descending), ``values`` f32 [k]
    (``x[indices]``); ``decompress`` scatters them into zeros."""

    k: int = 1
    approx: bool = False

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        idx = topk_select(x, self.k)
        return {"indices": idx.to(torch.int32), "values": x[idx]}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        vals = payload["values"]
        out = torch.zeros(self.size, dtype=torch.float32, device=vals.device)
        out[payload["indices"].long()] = vals
        return out

    def wire_bytes(self) -> int:
        return self.k * 8


@dataclasses.dataclass(frozen=True)
class RandomkCodec(Codec):
    """k pseudo-random (index, value) pairs seeded by (seed, step), so
    every party draws the same indices (randomk.cc:24-60).

    The indices come from the B5 kernel on every CUDA launch (the JAX
    codec launches its kernel only from k = 32768 on; its smaller k takes
    the jnp twin, with the same indices). The gather ``x[idx]`` and the
    decompress's scatter stay plain torch, as they are plain jnp there.
    payload: ``indices`` int32 [k], ``values`` f32 [k]."""

    k: int = 1
    seed: int = 0

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        idx = randomk_indices(rng.uniform_base(self.seed, step), self.size,
                              self.k, x.device)
        return {"indices": idx, "values": x[idx.long()]}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        vals = payload["values"]
        out = torch.zeros(self.size, dtype=torch.float32, device=vals.device)
        # index_put_ without accumulate: a repeated index keeps one of
        # its (equal) values, like ``.at[idx].set``
        out[payload["indices"].long()] = vals
        return out

    def wire_bytes(self) -> int:
        return self.k * 8


@dataclasses.dataclass(frozen=True)
class DitheringCodec(Codec):
    """Stochastic s-level quantization (dithering.cc:25-80): normalize by
    the max or the L2 norm, map |x| onto s linear levels or onto powers of
    two (natural), round up with the probability of the fractional
    position, ship dense signed int8 levels and the f32 norm.

    The norm (the JAX codec leaves it to XLA) sums in XLA's order
    (``kernels.xla_sum``) with a correctly rounded square root, so it is
    the JAX codec's bit for bit, and reaches the B4 kernel as a device
    scalar, never read on the host.
    ``decompress`` and the error-feedback ``residual`` round as the JAX
    codec does under jit (``kernels.dithering_dequantize``): |lv| * (1/s)
    for |lv| / s, the residual as one FMA; under the natural partition
    2^-(|lv| - 1) is exact, where XLA's exp2 is off by a few ulp.
    payload: ``levels`` int8 [n], ``norm`` f32 []."""

    s: int = 127                  # levels; <= 127 so a level fits int8
    partition: str = "linear"     # or "natural"
    normalize: str = "max"        # or "l2"
    seed: int = 0

    def __post_init__(self):
        if not (1 <= self.s <= 127):
            raise ValueError(
                f"dithering s={self.s} out of range [1, 127] (levels are "
                f"carried as int8; larger s would silently wrap)")
        if self.partition not in ("linear", "natural"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.normalize not in ("max", "l2"):
            raise ValueError(f"unknown normalize {self.normalize!r}")

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        absx = x.abs()
        m = absx.max()
        if self.normalize == "max":
            norm = m
        else:
            # scale-invariant two-pass L2: x*x overflows near f32's max
            safe_m = torch.clamp_min(m, 1e-30)
            norm = safe_m * sqrt_f32(xla_sum(absx / safe_m, square=True))
        return torch.clamp_min(norm, 1e-30).to(torch.float32)

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        norm = self.norm(x)
        levels = dithering_levels(x, norm, rng.uniform_base(self.seed, step),
                                  self.s, self.partition)
        return {"levels": levels, "norm": norm}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        return dithering_dequantize(payload["levels"], payload["norm"],
                                    self.s, self.partition)

    def residual(self, x: torch.Tensor,
                 payload: Dict[str, Any]) -> torch.Tensor:
        # x - dec * norm in one rounding, written into x
        return dithering_dequantize(payload["levels"], payload["norm"],
                                    self.s, self.partition, residual_of=x)

    def wire_bytes(self) -> int:
        return self.size + 4
