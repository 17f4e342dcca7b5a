"""Megatron tensor parallelism over a mesh axis: the products, the
embedding and the cross entropy of a model whose leaves lie split as
``parallel/sharding.py``'s ``llama_param_specs`` and
``bert_param_specs`` lay them out.

The GSPMD tier of byteps_tpu/parallel/. In JAX those tables drive XLA's
partitioner, which writes the collectives from the layouts; torch has no
compiler to do that, so the port writes them as explicit Megatron
regions over its own mesh (``collectives.copy_to``, ``reduce_from``,
``gather_from``, ``scatter_to``) and not as DTensor: the mesh is named
process groups, not a ``DeviceMesh`` (``parallel/mesh.py`` says why), and
DTensor has no sharding rule for the flash kernel's custom op nor for the
stacked-layer FSDP layout.

Each rank holds its slice of every split leaf and the whole of every
replicated one; the activations between the regions are replicated over
the axis:

- column-parallel (the out dim split: ``wq``, ``wk``, ``wv``, ``w_gate``,
  ``w_up``, ``w_in``, ``mlm_dense``): ``copy_to`` the replicated input,
  then the local product, whose output is this rank's columns;
- row-parallel (the in dim split: ``wo``, ``w_down``, ``w_out``): the
  local product of this rank's columns, then ``reduce_from``;
- vocab-parallel embedding (rows [r V/n, (r + 1) V/n) of the table on
  rank r): tokens outside the rank's rows look up zeros, then
  ``reduce_from``;
- vocab-parallel cross entropy over the logits of this rank's vocab
  slice: an all-reduce max (no gradient), an all-reduce of the sum of
  exponentials and one of the target's logit; the backward is the local
  softmax minus the local one-hot, with no collective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .collectives import (_all_reduce, _group, axis_index, axis_size,
                          copy_to, pmax, reduce_from)


def check_heads(n_heads: int, n_kv_heads: int, axis: str) -> int:
    """The axis size, after checking that it splits the query and the KV
    heads alike (a contiguous column split then keeps every rank's query
    heads with their own KV heads: query head h reads KV head h //
    (n_heads / n_kv_heads)). GSPMD would reshard KV heads that do not
    split; the port does not."""
    n = axis_size(axis)
    if n_heads % n or n_kv_heads % n:
        raise ValueError(
            f"tensor parallelism over {axis!r} of size {n} needs n_heads "
            f"({n_heads}) and n_kv_heads ({n_kv_heads}) divisible by it: "
            f"each rank holds n_heads / {n} query and n_kv_heads / {n} KV "
            f"heads")
    return n


def column_parallel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    axis: Optional[str]) -> list:
    """``x @ w`` for each column-split ``w``: one ``copy_to`` for them
    all (its backward is one all-reduce of the summed gradient). With
    ``axis`` None, the plain products."""
    if axis is not None:
        x = copy_to(x, axis)
    return [x @ w for w in weights]


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 axis: Optional[str]) -> torch.Tensor:
    """``x @ w`` for a row-split ``w`` and this rank's columns ``x``,
    summed over the axis (with ``axis`` None, the plain product)."""
    return x @ w if axis is None else reduce_from(x @ w, axis)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         axis: str, dtype: torch.dtype) -> torch.Tensor:
    """``table`` (this rank's rows of the [V, d] embedding) looked up at
    ``tokens`` in ``dtype``: zeros where a token's row lies on another
    rank, summed over the axis."""
    rows = table.shape[0]
    local = tokens.long() - axis_index(axis) * rows
    inside = (local >= 0) & (local < rows)
    x = table.to(dtype)[local.clamp(0, rows - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                      device=x.device))
    return reduce_from(x, axis)


class _VocabParallelXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets, axis):
        group = _group(axis)
        rows = logits.shape[-1]
        lf = logits.to(torch.float32)
        m = pmax(lf.amax(-1), axis)
        s = _all_reduce(torch.exp(lf - m[..., None]).sum(-1), group)
        local = targets.long() - axis_index(axis) * rows
        inside = (local >= 0) & (local < rows)
        loc = local.clamp(0, rows - 1)
        picked = torch.gather(lf, -1, loc[..., None])[..., 0]
        picked = _all_reduce(torch.where(inside, picked,
                                         torch.zeros_like(picked)), group)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, loc, inside)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, loc, inside = ctx.saved_tensors
        p = torch.exp(logits.to(torch.float32) - lse[..., None])
        p.scatter_add_(-1, loc[..., None],
                       -inside[..., None].to(torch.float32))
        return (p * g[..., None]).to(logits.dtype), None, None


def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        axis: str) -> torch.Tensor:
    """Per-position cross entropy, in f32, of the logits of this rank's
    vocab slice [..., V / n] at the global ``targets`` [...]: the
    logsumexp over the whole vocab minus the target's logit, the same on
    every rank. Its gradient is this rank's slice of the softmax minus the
    one-hot, times the position's cotangent."""
    return _VocabParallelXent.apply(logits, targets, axis)
