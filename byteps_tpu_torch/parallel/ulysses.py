"""Ulysses sequence parallelism: all-to-alls from sequence-split to
head-split and back.

Port of byteps_tpu/parallel/ulysses.py (DeepSpeed-Ulysses,
arXiv:2309.14509). With the sequence split over the ``sp`` axis, two
all-to-alls re-split q, k and v from sequence to heads, each rank runs
plain attention over the whole sequence for its heads, and a last
all-to-all restores the sequence split. Against ring attention it moves
activations twice through all-to-all and reuses the local attention:
``flash=True`` takes ``ops.flash_attention``'s ``make_flash_attn``, the
B1 kernel on the card (its blockwise twin on the CPU), at [B, S, H / n,
D] with as many KV heads as query heads (GQA expands before the
all-to-all).
"""

from __future__ import annotations

import numpy as np
import torch

from .collectives import all_to_all, axis_size
from .mesh import SP_AXIS


def _dense_causal(q, k, v, causal: bool):
    """Plain attention over the whole sequence; q/k/v [B, S, H, D] with
    one KV head per query head."""
    B, S, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=q.device))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = SP_AXIS, causal: bool = True,
                      local_attn=None) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis``, by
    re-splitting heads. q [B, S_local, H, D], k/v [B, S_local, Hkv, D],
    Hkv | H, H divisible by the axis size; inside ``with mesh:``.
    Returns [B, S_local, H, D]. The sequence chunks concatenate in rank
    order, so global RoPE positions line up with the causal mask."""
    n = axis_size(axis)
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(
            f"ulysses requires n_heads ({H}) divisible by the '{axis}' "
            f"axis size ({n}); use ring attention otherwise")
    groups = H // k.shape[2]
    if groups > 1:
        # expand the GQA groups so every rank gets whole (q-head, kv-head)
        # pairs after the head split
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)

    def seq_to_heads(x):
        # [B, S/P, H, D] -> [B, S, H/P, D]
        return all_to_all(x, axis, split_axis=2, concat_axis=1)

    q, k, v = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if local_attn is None:
        o = _dense_causal(q, k, v, causal)
    else:
        o = local_attn(q, k, v)
    # [B, S, H/P, D] -> [B, S/P, H, D]
    return all_to_all(o, axis, split_axis=1, concat_axis=2)


def make_ulysses_attn(axis: str = SP_AXIS, causal: bool = True,
                      flash: bool = False):
    """Bind ulysses_attention as a models.llama ``attn_impl``;
    ``flash=True`` runs the local attention through
    ``ops.flash_attention.make_flash_attn``."""
    local = None
    if flash:
        from ..ops.flash_attention import make_flash_attn
        local = make_flash_attn(causal=causal)

    def impl(q, k, v):
        return ulysses_attention(q, k, v, axis=axis, causal=causal,
                                 local_attn=local)

    return impl
