"""The streaming-softmax fold of ring attention.

Port of ``_block_attn_accum`` (byteps_tpu/parallel/ring_attention.py:35-52):
fold one KV block into running max, denominator and output, the math that
``ops.flash_attention.blockwise_attention`` loops over. The ring itself
(sequence parallelism) is not ported yet.
"""

from __future__ import annotations

import torch

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
