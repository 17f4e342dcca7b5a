"""Mixtral-style sparse Mixture-of-Experts transformer, on one device, in
PyTorch.

Port of byteps_tpu/models/moe.py with its leaf names, shapes and
numerics, for ``ep_axis=None``: Switch-style top-k routing into
capacity-bounded [tokens, experts, capacity] dispatch and combine masks
(``_route``), the experts' SwiGLU as batched products
(``_expert_ffn``), Llama's attention sublayer and RMSNorm
(``models/llama.py``), the Switch load-balancing loss. Leaves as in
``init_params``: ``embed`` [V, d], ``blocks`` stacked on [n_layers]
(attention as Llama's, ``router`` [L, d, E], ``w_gate``/``w_up`` [L, E,
d, h], ``w_down`` [L, E, h, d]), ``final_norm``, ``lm_head`` [d, V].

Routing as ``_route`` computes it: the router logits and softmax in f32;
the top k of each token by (probability descending, expert ascending),
``lax.top_k``'s order on ties, through a stable sort; each choice slot
k-major claims its expert's next position, by an int32 exclusive
cumsum; a position at or past the capacity is dropped (a zero row, as
``one_hot`` of an out-of-range index is).

Expert parallelism: with ``ep_axis`` (a mesh axis, inside ``with
mesh:``), the experts dim of the expert leaves is split over the axis
(``parallel.sharding.moe_param_specs``) and two tiled all-to-alls move
the dispatched slots to their experts' ranks and back;
``ep_grad_correction`` turns each rank's gradient into the gradient of
the ranks' mean loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.state import resolve_device
from . import llama as L
from .common import (ParamTree, from_numpy, module_params,  # noqa: F401
                     param_count)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    n_experts: int = 8
    top_k: int = 2
    expert_hidden: int = 14336
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def as_llama(self) -> L.LlamaConfig:
        """The attention-relevant subset as a LlamaConfig (for the shared
        attention sublayer)."""
        return L.LlamaConfig(
            vocab_size=self.vocab_size, dim=self.dim, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            hidden_dim=self.expert_hidden, max_seq_len=self.max_seq_len,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            dtype=self.dtype, param_dtype=self.param_dtype, remat=False)

    @staticmethod
    def tiny(vocab_size: int = 256, seq: int = 64) -> "MoEConfig":
        return MoEConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, n_experts=4, top_k=2,
                         expert_hidden=128, max_seq_len=seq, remat=False,
                         capacity_factor=2.0)

    @staticmethod
    def small(vocab_size: int = 32000) -> "MoEConfig":
        """Mixtral-flavored benchmark config at ~125M-active scale."""
        return MoEConfig(vocab_size=vocab_size, dim=768, n_layers=12,
                         n_heads=12, n_kv_heads=4, n_experts=8, top_k=2,
                         expert_hidden=2048, max_seq_len=2048)


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Static per-expert token capacity for a batch of n_tokens."""
    return max(1, int(math.ceil(
        cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor)))


def param_shapes(cfg: MoEConfig) -> Dict[str, Any]:
    d, h, E, Ln = cfg.dim, cfg.expert_hidden, cfg.n_experts, cfg.n_layers
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "attn_norm": (Ln, d),
            "wq": (Ln, d, nh * hd),
            "wk": (Ln, d, nkv * hd),
            "wv": (Ln, d, nkv * hd),
            "wo": (Ln, nh * hd, d),
            "mlp_norm": (Ln, d),
            "router": (Ln, d, E),
            "w_gate": (Ln, E, d, h),
            "w_up": (Ln, E, d, h),
            "w_down": (Ln, E, h, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """The JAX scales: norms 1, matrices N(0, 1/fan_in) (fan_in the
    second-to-last dim), the router and the embedding N(0, 0.02²)."""
    device = resolve_device(device)

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2])
        return torch.randn(shape, generator=generator, device=device,
                           dtype=cfg.param_dtype) * scale

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)

    shapes = param_shapes(cfg)
    return {
        "embed": dense(shapes["embed"], scale=0.02),
        "blocks": {k: (ones(s) if k.endswith("norm") else
                       dense(s, 0.02 if k == "router" else None))
                   for k, s in shapes["blocks"].items()},
        "final_norm": ones(shapes["final_norm"]),
        "lm_head": dense(shapes["lm_head"]),
    }


def params_from_jax(tree: Dict[str, Any], device=None,
                    cfg: Optional[MoEConfig] = None) -> Dict[str, Any]:
    """The JAX parameter dict (numpy leaves) as f32 tensors on
    ``device``, its shapes checked against ``cfg`` when given."""
    return from_numpy(tree, device, torch.float32,
                      param_shapes(cfg) if cfg is not None else None)


class MoE(ParamTree):
    """The MoE model's parameters as ``nn.Parameter`` leaves under the
    JAX names (``embed``, ``blocks.router``, ...); ``params()`` is the
    nested dict."""

    def __init__(self, cfg: MoEConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(module_params("MoE", cfg, param_shapes(cfg),
                                       init_params, device, generator,
                                       params, cfg.param_dtype))
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor):
        return forward(self.params(), tokens, self.cfg)


# --------------------------------------------------------------------- #
# routing + expert layer
# --------------------------------------------------------------------- #

def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) [T, k] of each row's k largest, by (value
    descending, index ascending): ``lax.top_k``'s order, lower index
    first among equal values. A stable descending sort keeps equal
    values in index order (``codecs.topk_select`` ends in the same
    sort); ``torch.topk`` promises no order among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route_probs(probs: torch.Tensor, cfg: MoEConfig, cap: int):
    """``_route`` from the router's softmax [T, E] on: (dispatch [T, E,
    C] f32 mask, combine [T, E, C] gate-weighted mask, Switch aux
    loss)."""
    T, E = probs.shape
    k = cfg.top_k
    gate_vals, gate_idx = top_k(probs, k)                # [T, k]
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # choice slots flattened k-major: slot 0 of every token claims
    # capacity before any slot 1 (Switch priority)
    idx_flat = gate_idx.T.reshape(-1)                    # [k*T]
    onehot_i = F.one_hot(idx_flat, E).to(torch.int32)    # [k*T, E]
    onehot = onehot_i.to(torch.float32)
    pos_in_expert = torch.cumsum(onehot_i, 0, dtype=torch.int32) - onehot_i
    pos = torch.sum(pos_in_expert * onehot_i, -1)        # [k*T] int32
    keep = pos < cap
    # one_hot(pos, cap): a position >= cap is a zero row
    slot = (pos[:, None] == torch.arange(cap, device=probs.device,
                                         dtype=torch.int32)).to(torch.float32)
    mask = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
    mask = mask.reshape(k, T, E, cap)                    # [k, T, E, C]
    dispatch = torch.sum(mask, 0)
    combine = torch.sum(mask * gate_vals.T.reshape(k, T, 1, 1), 0)

    # Switch aux loss: E * sum_e f_e * p_e (f: the fraction of tokens
    # whose first choice is e, p: the mean router probability)
    prime = F.one_hot(gate_idx[:, 0], E).to(torch.float32)
    aux = E * torch.sum(torch.mean(prime, 0) * torch.mean(probs, 0))
    return dispatch, combine, aux


def router_probs(x_flat: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """The router's softmax [T, E], in f32."""
    logits = x_flat.to(torch.float32) @ router_w.to(torch.float32)
    return torch.softmax(logits, -1)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
           cap: int):
    """Top-k capacity-bounded routing of x_flat [T, d]: (dispatch,
    combine, aux_loss)."""
    return route_probs(router_probs(x_flat, router_w), cfg, cap)


def _expert_ffn(h: torch.Tensor, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """SwiGLU per expert. h: [E, C, d]."""
    g = F.silu(torch.einsum("ecd,edh->ech", h, w_gate.to(dtype)))
    u = torch.einsum("ecd,edh->ech", h, w_up.to(dtype))
    return torch.einsum("ech,ehd->ecd", g * u, w_down.to(dtype))


def moe_layer(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: MoEConfig,
              ep_axis: Optional[str] = None):
    """The MoE FFN of x [B, S, d] with one layer's params ``p``: route,
    dispatch, the experts, combine. Returns (output [B, S, d],
    aux_loss).

    With ``ep_axis`` (inside ``with mesh:``), p's expert leaves hold this
    rank's E / P experts: the dispatched slots [E, C, d] travel to their
    experts' ranks by an all-to-all (each expert then sees P * C slots,
    C from every rank) and the experts' outputs come back by the inverse
    one."""
    B, S, d = x.shape
    dt = cfg.dtype
    x_flat = x.reshape(B * S, d)
    dispatch, combine, aux = _route(x_flat, p["router"], cfg,
                                    capacity(cfg, B * S))
    h = torch.einsum("tec,td->ecd", dispatch.to(dt), x_flat)
    if ep_axis is None:
        out_e = _expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], dt)
    else:
        from ..parallel.collectives import all_to_all
        h = all_to_all(h, ep_axis, split_axis=0,
                       concat_axis=1)                 # [E_local, P*C, d]
        out_e = _expert_ffn(h, p["w_gate"], p["w_up"], p["w_down"], dt)
        out_e = all_to_all(out_e, ep_axis, split_axis=1,
                           concat_axis=0)             # [E, C, d]
    out = torch.einsum("tec,ecd->td", combine.to(dt), out_e)
    return out.reshape(B, S, d), aux


# --------------------------------------------------------------------- #
# full model
# --------------------------------------------------------------------- #

def _moe_block(x, p, cos, sin, cfg: MoEConfig,
               ep_axis: Optional[str] = None):
    """Attention (Llama's sublayer) + the MoE FFN; p: one layer's
    params."""
    x = L.attn_sublayer(x, p, cos, sin, cfg.as_llama())
    h = L._rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    ffn, aux = moe_layer(h, p, cfg, ep_axis)
    return x + ffn, aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig,
            ep_axis: Optional[str] = None):
    """tokens [B, S] -> (logits [B, S, vocab] in cfg.dtype, the mean aux
    loss over the layers); ``ep_axis``: see ``moe_layer``."""
    B, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    cos, sin = L.rope_cache(cfg.as_llama(), S, x.device)
    blk = params["blocks"]
    auxes = []
    for layer in range(cfg.n_layers):
        p = {k: v[layer] for k, v in blk.items()}
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(_moe_block, x, p, cos, sin, cfg, ep_axis,
                                use_reentrant=False)
        else:
            x, aux = _moe_block(x, p, cos, sin, cfg, ep_axis)
        auxes.append(aux)
    x = L._rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(cfg.dtype), torch.mean(torch.stack(auxes))


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def ep_grad_correction(grads: Dict[str, Any], axis: str) -> Dict[str, Any]:
    """Each rank's gradient of its own loss to the gradient of the ranks'
    mean loss, under expert parallelism: the expert leaves already hold
    the sum over the ranks (the dispatch all-to-all's transpose brings
    every rank's cotangents to the expert's owner) and take the 1 / P of
    the mean; every other leaf is this rank's part and takes the
    ``pmean`` over ``axis``."""
    from ..parallel.collectives import axis_size, pmean

    def fix(path, leaf):
        if path & set(EXPERT_LEAVES):
            return leaf / axis_size(axis)
        return pmean(leaf, axis)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path | {k}) for k, v in node.items()}
        return fix(path, node)

    with torch.no_grad():
        return walk(grads, frozenset())


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: MoEConfig, ep_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy + the router aux loss; ``ep_axis``: see
    ``moe_layer`` and ``ep_grad_correction``."""
    inputs, targets = L.split_batch(batch)
    logits, aux = forward(params, inputs, cfg, ep_axis)
    return L.next_token_xent(logits, targets) + cfg.router_aux_weight * aux
