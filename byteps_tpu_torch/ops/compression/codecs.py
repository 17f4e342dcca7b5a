"""Gradient-compression codecs over flat f32 tensors.

Port of byteps_tpu/ops/compression/codecs.py. Onebit is ported; topk,
randomk and dithering are not yet (ops/compression/__init__.py raises for
them). A codec implements ``compress(x, step) -> payload`` and
``decompress(payload) -> x_hat``; ``wire_bytes`` is the payload size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .kernels import n_words, onebit_pack, onebit_unpack


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base: identity codec."""

    size: int  # number of f32 elements of the uncompressed flat tensor

    def compress(self, x: torch.Tensor, step: int = 0) -> Dict[str, Any]:
        return {"raw": x}

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        return payload["raw"]

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
        # the L1-mean stays a plain reduction, as the JAX codec leaves it
        # to XLA; only the pack is a kernel
        scale = x.abs().mean() if self.scaled else \
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
