"""Named-sharding rules: how model parameters and batches lay out over
the mesh, and each rank's slice of them.

Port of byteps_tpu/parallel/sharding.py. A spec is ``P``, a tuple with
one entry per dimension: ``None`` (not split), an axis name, or a tuple
of axis names (split over their product, major first), as JAX's
``PartitionSpec``. The six tables equal the JAX package's:

- ``llama_param_specs``, ``bert_param_specs``: Megatron tensor
  parallelism over ``tp`` (column-parallel QKV and MLP in, row-parallel
  attention out and MLP down, vocab-parallel embedding and head);
- ``llama_pp_param_specs``: the stacked layer dim over ``pp``;
- ``moe_param_specs``: the experts dim over ``ep``;
- ``fsdp_param_specs``: ZeRO-3 / FSDP, each large leaf over ``dp``;
- ``batch_spec``: tokens over ``dp`` (and the sequence over ``sp``).

In JAX these drive GSPMD (XLA infers the collectives from the layouts)
or ``shard_map`` (the code writes them). Torch has no compiler to infer
them, so here the tables place the parameters: ``place_params`` gives
this rank its slice of every leaf, the counterpart of ``device_put``
with a ``NamedSharding``, and ``gather_params`` puts the slices together
again. The code writes the collectives: the shard_map tier's in
``ring_attention.py``, ``ulysses.py``, ``pipeline.py``; the GSPMD tier's
(the tp and fsdp tables) in ``tensor_parallel.py`` (Megatron regions),
``fsdp.py`` (the gathers) and ``spmd.py`` (the step).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .collectives import all_gather
from .mesh import DP_AXIS, EP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS, Mesh


class P(tuple):
    """A partition spec: ``P(None, "tp")`` splits dim 1 over ``tp``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def llama_param_specs(params_shape: Any = None) -> Any:
    """Specs of models/llama.py's parameters (layers stacked on a leading
    dim L, which never splits)."""
    return {
        "embed": P(TP_AXIS, None),          # vocab-parallel
        "final_norm": P(),
        "lm_head": P(None, TP_AXIS),        # vocab-parallel out
        "blocks": {
            "attn_norm": P(),
            "wq": P(None, None, TP_AXIS),   # column-parallel
            "wk": P(None, None, TP_AXIS),
            "wv": P(None, None, TP_AXIS),
            "wo": P(None, TP_AXIS, None),   # row-parallel
            "mlp_norm": P(),
            "w_gate": P(None, None, TP_AXIS),
            "w_up": P(None, None, TP_AXIS),
            "w_down": P(None, TP_AXIS, None),
        },
    }


def bert_param_specs(params_shape: Any = None) -> Any:
    b = {
        "wq": P(None, None, TP_AXIS), "bq": P(),
        "wk": P(None, None, TP_AXIS), "bk": P(),
        "wv": P(None, None, TP_AXIS), "bv": P(),
        "wo": P(None, TP_AXIS, None), "bo": P(),
        "ln1_g": P(), "ln1_b": P(),
        "w_in": P(None, None, TP_AXIS), "b_in": P(),
        "w_out": P(None, TP_AXIS, None), "b_out": P(),
        "ln2_g": P(), "ln2_b": P(),
    }
    return {
        "tok_embed": P(TP_AXIS, None), "pos_embed": P(), "type_embed": P(),
        "embed_ln_g": P(), "embed_ln_b": P(),
        "blocks": b,
        "mlm_dense": P(None, TP_AXIS), "mlm_bias": P(),
        "mlm_ln_g": P(), "mlm_ln_b": P(),
        "mlm_out_bias": P(),
    }


def llama_pp_param_specs() -> Any:
    """Pipeline-parallel Llama: the stacked [n_layers] dim of every block
    leaf over ``pp`` (each stage owns n_layers / P layers); embeddings,
    head and final norm replicate (their gradients are summed over the
    stages, parallel/pipeline.py)."""
    return {
        "embed": P(),
        "final_norm": P(),
        "lm_head": P(),
        "blocks": {
            k: P(PP_AXIS) for k in
            ("attn_norm", "wq", "wk", "wv", "wo",
             "mlp_norm", "w_gate", "w_up", "w_down")
        },
    }


def moe_param_specs() -> Any:
    """models/moe.py under expert parallelism: the experts dim over
    ``ep``; attention, router and embeddings replicate."""
    return {
        "embed": P(),
        "final_norm": P(),
        "lm_head": P(),
        "blocks": {
            "attn_norm": P(),
            "wq": P(), "wk": P(), "wv": P(),
            "wo": P(),
            "mlp_norm": P(),
            "router": P(),
            # [L, E, d, h]: experts over ep
            "w_gate": P(None, EP_AXIS),
            "w_up": P(None, EP_AXIS),
            "w_down": P(None, EP_AXIS),
        },
    }


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def fsdp_param_specs(params: Any, axis: str = DP_AXIS, *, axis_size: int,
                     base_specs: Any = None,
                     min_elements: int = 1 << 14) -> Any:
    """ZeRO-3 / FSDP layout: each leaf of at least ``min_elements`` gets
    ``axis`` on its first dimension that ``axis_size`` divides and that
    ``base_specs`` (e.g. the Megatron rules, for dp x tp) leaves unsplit;
    other leaves keep their base spec (replicated over ``axis``).
    ``params`` leaves are tensors or anything with a ``shape``."""

    def leaf_spec(leaf, base=None):
        shape = tuple(getattr(leaf, "shape", ()))
        entries = list(base) if base is not None else []
        entries += [None] * (len(shape) - len(entries))
        if int(np.prod(shape or (0,))) < min_elements:
            return P(*entries)
        for i, d in enumerate(shape):
            if entries[i] is None and d % axis_size == 0:
                entries[i] = axis
                return P(*entries)
        return P(*entries)

    if base_specs is None:
        return _tree_map(leaf_spec, params)
    return _tree_map(leaf_spec, params, base_specs)


def mirror_opt_specs(optimizer: torch.optim.Optimizer, params: Any,
                     param_specs: Any) -> Any:
    """Specs of a ``torch.optim`` optimizer's state, as a tree of the
    parameters' paths, each a dict of its state's keys: a tensor of the
    parameter's shape (``exp_avg``, ``exp_avg_sq``, ``momentum_buffer``,
    ...) takes the parameter's spec, anything else (``step``) replicates,
    as JAX's rule matches optimizer state to parameters by path and
    shape. The state is read as it stands: torch makes it at the first
    step."""

    def leaf(p, spec):
        return {k: spec if torch.is_tensor(v) and v.shape == p.shape
                else P() for k, v in optimizer.state.get(p, {}).items()}

    return _tree_map(leaf, params, _expand(param_specs, params))


def batch_spec(shard_seq: bool = False) -> P:
    """Batch tokens [B, S]: B over dp, optionally S over sp."""
    return P(DP_AXIS, SP_AXIS) if shard_seq else P(DP_AXIS)


def _expand(specs: Any, params: Any) -> Any:
    """``specs`` with a ``P`` at a subtree of ``params`` repeated over its
    leaves (a spec tree may be a prefix of the parameter tree)."""
    if isinstance(specs, P):
        return _tree_map(lambda _: specs, params)
    return {k: _expand(specs[k], v) for k, v in params.items()}


def _split(mesh: Mesh, entry) -> tuple:
    """(pieces, this rank's piece) of one spec entry."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    n, idx = 1, 0
    for name in names:                      # major to minor
        if name not in mesh.shape:
            raise ValueError(f"spec axis {name!r} is not an axis of "
                             f"{mesh}")
        n *= mesh.shape[name]
        idx = idx * mesh.shape[name] + mesh.axis_index(name)
    return n, idx


def place_params(params: Any, mesh: Mesh, spec_tree: Any) -> Any:
    """This rank's slice of every leaf of ``params`` by its spec: chunk
    ``axis_index`` of ``axis_size`` along each split dimension, as a
    leaf of its own (a copy)."""

    def place(x, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            n, idx = _split(mesh, entry)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split into {n} over {entry!r}")
            x = x.chunk(n, dim)[idx]
        return x.detach().clone()

    return _tree_map(place, params, _expand(spec_tree, params))


def gather_params(params: Any, mesh: Mesh, spec_tree: Any) -> Any:
    """The inverse of ``place_params``: every rank's slices of each leaf
    put together (an all-gather along each split dimension)."""

    def gather(x, spec):
        x = x.detach()
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            for name in reversed(names):    # minor first
                x = all_gather(x, dim, mesh.group(name))
        return x

    return _tree_map(gather, params, _expand(spec_tree, params))
