"""Gradient compression for byteps_tpu_torch.

Port of byteps_tpu/ops/compression/__init__.py:

- ``make_compressor(kwargs, size)``: the string-kwargs registry of the
  reference's CompressorRegistry (compressor_registry.cc:39-56), keys as
  in BytePS's python surface (``compressor``, ``ef``, ``momentum``,
  ``scaling``, ``momentum_mu``, and for randomk/dithering ``k``,
  ``seed``, ``s``, ``partition_type``, ``normalize_type``, and for topk
  ``k`` and ``approx``): onebit, topk, randomk and dithering.
- ``compressed_psum_tree``: each replica compresses its gradient, the
  payloads are all-gathered over the ``dp`` group, and every replica
  decompresses each rank's payload and sums them in rank order
  (core_loops.cc:498-648 collapsed into one collective, as in the JAX
  package), for every codec.
- ``CompressionTransform``: the per-leaf EF/momentum state and step count
  that ``training.DistributedOptimizer`` carries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ...config import DEFAULT_MIN_COMPRESS_BYTES
from ..push_pull import all_reduce_
from . import kernels as K
from .codecs import (
    Codec, DitheringCodec, OnebitCodec, RandomkCodec, TopkCodec, resolve_k,
)
from .feedback import CompressorStack

__all__ = [
    "Codec", "OnebitCodec", "TopkCodec", "RandomkCodec", "DitheringCodec",
    "CompressorStack", "resolve_k",
    "make_compressor", "default_stacks", "compressed_psum_tree",
    "CompressionTransform",
]


def parse_bool_kwarg(kwargs: Dict[str, str], name: str,
                     default: str = "false") -> bool:
    return str(kwargs.get(name, default)).lower() in ("1", "true", "yes")


def parse_ef_kwarg(kwargs) -> bool:
    """'vanilla' or a boolean-true spelling enables vanilla EF; a typo
    fails instead of silently dropping EF."""
    v = str(kwargs.get("ef", "")).lower()
    if v in ("vanilla", "true", "1", "yes"):
        return True
    if v in ("", "0", "false", "no", "none", "off"):
        return False
    raise ValueError(f"unknown ef type {kwargs.get('ef')!r}; "
                     f"use 'vanilla' (or a boolean spelling)")


def parse_momentum_kwarg(kwargs) -> bool:
    mom = str(kwargs.get("momentum", "")).lower()
    if mom == "nesterov":
        return True
    if mom in ("", "none", "0", "false", "no", "off"):
        return False
    raise ValueError(f"unknown momentum type "
                     f"{kwargs.get('momentum')!r}; use 'nesterov'")


def _make_codec(name: str, kwargs: Dict[str, str], size: int) -> Codec:
    """The base codec, with the kwargs of the JAX registry
    (byteps_tpu/ops/compression/__init__.py:94-123)."""
    if name == "onebit":
        return OnebitCodec(size=size,
                           scaled=parse_bool_kwarg(kwargs, "scaling", "true"))
    if name == "topk":
        return TopkCodec(size=size,
                         k=resolve_k(float(kwargs.get("k", 0.01)), size),
                         approx=parse_bool_kwarg(kwargs, "approx"))
    if name == "randomk":
        return RandomkCodec(size=size,
                            k=resolve_k(float(kwargs.get("k", 0.01)), size),
                            seed=int(kwargs.get("seed", 0)))
    # dithering: "s" with the "k" fallback, since the reference passes the
    # level count as compressor_k (dithering.cc:31)
    return DitheringCodec(size=size,
                          s=int(kwargs.get("s", kwargs.get("k", 127))),
                          partition=kwargs.get("partition_type", "linear"),
                          normalize=kwargs.get("normalize_type", "max"),
                          seed=int(kwargs.get("seed", 0)))


PORTED = ("onebit", "topk", "randomk", "dithering")


def make_compressor(kwargs: Dict[str, str], size: int) -> CompressorStack:
    """The momentum -> EF -> codec stack from string kwargs. The host
    tier's lossless codec has no device or collective form, here as in
    the JAX package: it is an unknown compressor."""
    name = kwargs.get("compressor")
    if name not in PORTED:
        raise ValueError(f"unknown compressor {name!r}; have {list(PORTED)}")
    codec = _make_codec(name, kwargs, size)
    use_ef = parse_ef_kwarg(kwargs)
    mu = None
    if parse_momentum_kwarg(kwargs):
        if not use_ef:
            raise ValueError("momentum requires ef=vanilla (reference "
                             "stacking order, compressor.h:28-52)")
        mu = float(kwargs.get("momentum_mu", 0.9))
    return CompressorStack(codec=codec, use_ef=use_ef, momentum_mu=mu)


def _resolve_min_compress_bytes(v: Optional[int]) -> int:
    """None -> BYTEPS_MIN_COMPRESS_BYTES as init() read it, else the
    compiled-in default."""
    if v is not None:
        return v
    from ...core.state import get_state
    st = get_state()
    return st.config.min_compress_bytes if st.initialized \
        else DEFAULT_MIN_COMPRESS_BYTES


def default_stacks(params: Sequence[torch.Tensor], kwargs: Dict[str, str],
                   min_compress_bytes: Optional[int] = None
                   ) -> List[Optional[CompressorStack]]:
    """One stack per tensor; None for tensors under ``min_compress_bytes``
    (counted at 4 bytes an element, BytePS operations.cc:361-364), which
    take the plain all-reduce."""
    limit = _resolve_min_compress_bytes(min_compress_bytes)
    return [make_compressor(kwargs, p.numel()) if p.numel() * 4 >= limit
            else None for p in params]


def _to_bytes(payload: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A payload as one flat uint8 tensor: its arrays' bytes in key
    order."""
    return torch.cat([payload[k].contiguous().reshape(-1).view(torch.uint8)
                      for k in sorted(payload)])


def _from_bytes(raw: torch.Tensor,
                like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``_to_bytes`` for a payload shaped as ``like``."""
    out, off = {}, 0
    for k in sorted(like):
        t = like[k]
        nb = t.numel() * t.element_size()
        piece = raw[off: off + nb]
        if off % t.element_size():
            piece = piece.clone()   # a view needs an aligned offset
        out[k] = piece.view(t.dtype).reshape(t.shape)
        off += nb
    return out


def rank_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the ranks' decompressed payloads as jitted ``jnp.sum``
    over the gathered axis adds them on XLA's CPU backend, element by
    element: one rank is returned as it is; up to 32 are added from zero
    in rank order; more go through the window levels of
    ``kernels.xla_sum`` first. Each addition rounds once."""
    if len(parts) == 1:
        return parts[0].clone()
    rows = parts
    for n, m, lo in K._sum_levels(len(parts))[:-1]:
        # a level of windows of 32 (zero padding: adding +0 to a sum
        # that started from +0 changes no bit)
        x = torch.stack(list(rows))
        pad = x.new_zeros((m * K.SUM_WINDOW - n,) + x.shape[1:])
        x = torch.cat([pad[:lo], x, pad[lo:]]).reshape(
            (m, K.SUM_WINDOW) + x.shape[1:])
        acc = torch.zeros_like(x[:, 0])
        for j in range(K.SUM_WINDOW):
            acc.add_(x[:, j])
        rows = list(acc)
    total = torch.zeros_like(rows[0])
    for r in rows:
        total.add_(r)
    return total


def compressed_psum_tree(grads: Sequence[torch.Tensor], states: Sequence,
                         stacks: Sequence[Optional[CompressorStack]],
                         group, step: int = 0, average: bool = True,
                         lr=None):
    """Reduce every gradient over ``group``: compressed leaves through
    compress -> all_gather of the payload's bytes -> decompress of each
    rank's payload -> the sum in rank order (``rank_sum``), the rest
    through all_reduce (byteps_tpu/ops/compression/__init__.py:168-203).
    Returns (reduced_grads, new_states); inputs are not modified."""
    n = dist.get_world_size(group)
    out, new_states = [], []
    for g, st, stack in zip(grads, states, stacks):
        if stack is None:
            out.append(all_reduce_(g.clone(), group, average))
            new_states.append(st)
            continue
        flat = g.reshape(-1).to(torch.float32)
        payload, new_st = stack.compress(flat, st, step, lr=lr)
        wire = _to_bytes(payload)
        gathered = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(gathered, wire, group=group)
        total = rank_sum([stack.decompress(_from_bytes(w, payload))
                          for w in gathered])
        if average:
            total = total / n
        out.append(total.reshape(g.shape).to(g.dtype))
        new_states.append(new_st)
    return out, new_states


class CompressionTransform:
    """Compressed cross-replica reduction with EF/momentum state, the
    counterpart of the JAX ``compression_transform`` (an optax
    transformation there). ``lr_schedule``: optional step -> lr callable;
    when given, the EF residual is rescaled across LR changes."""

    def __init__(self, params: Sequence[torch.Tensor],
                 kwargs: Dict[str, str], group=None, average: bool = True,
                 min_compress_bytes: Optional[int] = None,
                 lr_schedule=None):
        self.stacks = default_stacks(params, kwargs, min_compress_bytes)
        self.group = group
        self.average = average
        self.lr_schedule = lr_schedule
        self.states = [s.init_state(p.numel(), p.device) if s is not None
                       else {} for p, s in zip(params, self.stacks)]
        self.step = 0

    def update(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        lr = self.lr_schedule(self.step) if self.lr_schedule is not None \
            else None
        reduced, self.states = compressed_psum_tree(
            grads, self.states, self.stacks, self.group, self.step,
            average=self.average, lr=lr)
        self.step += 1
        return reduced
