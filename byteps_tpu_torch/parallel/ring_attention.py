"""Ring attention: exact attention with the sequence split over a
sequence-parallel mesh axis.

Port of byteps_tpu/parallel/ring_attention.py. Each rank keeps its
query shard and passes its K/V shard around the ring with ``ppermute``,
folding each block that arrives into a streaming softmax (running max,
denominator and output: ``block_attn_accum``, the math that
``ops.flash_attention.blockwise_attention`` loops over too). n - 1
rotations of the local K/V shard replace an all-gather of the sequence,
so a rank holds O(S / n) of it at a time.

Causality over the ring: at step r the block came from rank
(me - r) mod n. Blocks of earlier ranks attend fully, the rank's own
block takes the triangular mask, and blocks of later ranks are masked
out. As in JAX, every rank computes every fold and keeps it or not with
``where``: each rank then runs the same operations, so each reaches the
same backward collectives (the transposes of the rotations) in the same
order. The fold is plain torch ops, as JAX computes it outside any
Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import axis_index, axis_size, ppermute
from .mesh import SP_AXIS

NEG_INF = -1e30


def block_attn_accum(q, k, v, mask, m, l, o, scale: float):
    """Fold one KV block into the streaming softmax accumulators.

    q [B,Sq,H,D]; k,v [B,Sk,H,D]; mask [Sq,Sk] bool or None;
    m,l [B,H,Sq]; o [B,Sq,H,D]. Returns (m, l, o), new tensors.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
    m_blk = scores.amax(dim=-1)                            # [B,H,Sq]
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(scores - m_new[..., None])               # [B,H,Sq,Sk]
    corr = torch.exp(m - m_new)                            # [B,H,Sq]
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] \
        + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = SP_AXIS, causal: bool = True) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis``.

    q [B, S_local, H, D], k/v [B, S_local, Hkv, D] (GQA: Hkv divides H),
    inside ``with mesh:``. Returns [B, S_local, H, D] in q's dtype."""
    n = axis_size(axis)
    me = axis_index(axis)
    B, S, H, D = q.shape
    groups = H // k.shape[2]
    scale = 1.0 / np.sqrt(D)
    dev = q.device

    q32 = q.to(torch.float32)
    tri = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kr, vr = k, v
    for r in range(n):
        src = (me - r) % n                  # where this KV block came from
        # K/V ride the ring with their compact Hkv heads; the GQA
        # expansion happens per fold
        k32, v32 = kr.to(torch.float32), vr.to(torch.float32)
        if groups > 1:
            k32 = k32.repeat_interleave(groups, dim=2)
            v32 = v32.repeat_interleave(groups, dim=2)
        if causal:
            # src < me: full; src == me: triangular; src > me: masked out.
            # The same operations on every rank, kept or not by where
            full, diag = src < me, src == me
            mask = (tri & diag) | full
            m2, l2, o2 = block_attn_accum(q32, k32, v32, mask, m, l, o,
                                          scale)
            use = torch.tensor(full or diag, device=dev)
            m = torch.where(use, m2, m)
            l = torch.where(use, l2, l)
            o = torch.where(use, o2, o)
        else:
            m, l, o = block_attn_accum(q32, k32, v32, None, m, l, o, scale)
        # rotate K/V around the ring; the rotation after the last fold
        # would be dead traffic
        if r < n - 1:
            kr = ppermute(kr, axis, perm)
            vr = ppermute(vr, axis, perm)
    l = torch.clamp_min(l, 1e-30)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def make_ring_attn(axis: str = SP_AXIS, causal: bool = True):
    """Bind ring_attention as a models.llama ``attn_impl``."""

    def impl(q, k, v):
        return ring_attention(q, k, v, axis=axis, causal=causal)

    return impl
