"""Llama-3-style decoder-only transformer in PyTorch.

Port of byteps_tpu/models/llama.py with the same parameter names, layout
and numerics, so the JAX package's weights carry across
(``params_from_jax``) and both give the same loss:

- parameters as in ``init_params``: ``embed`` [V,d], ``blocks`` with
  every leaf stacked on a leading [n_layers] dim, ``final_norm`` [d],
  ``lm_head`` [d,V]; projections are ``x @ W``, not ``nn.Linear``;
- f32 master weights, compute in ``cfg.dtype`` (bf16), RMSNorm in f32,
  RoPE tables computed in float64 and cast to f32, then to x's dtype;
- logits stay in ``cfg.dtype``; the cross entropy is the logsumexp form
  in f32;
- ``cfg.remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
  does; the attention forward then runs twice per block and step.
  ``cfg.remat_policy`` names a ``jax.checkpoint_policies`` policy
  (``utils/remat.py``) whose saved outputs are not recomputed;
- ``cfg.xent_chunks`` > 0 takes the cross entropy per vocab chunk
  (``chunked_next_token_xent``), so the [B, S, V] logits are never
  resident at once;
- over a mesh (``parallel/``): ``sp_axis`` splits the sequence (ring
  attention by default, or Ulysses), ``forward_pp``/``loss_fn_pp``
  pipeline the layers over ``pp``, ``tp_axis`` splits the heads, the
  SwiGLU's inner dim and the vocab (Megatron,
  ``parallel/tensor_parallel.py``; the leaves as
  ``sharding.llama_param_specs`` lays them out), and a leaf may be an
  FSDP ``parallel.fsdp.Sharded``, gathered where it is used (a block's
  inside the block's checkpoint).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.state import resolve_device
from ..parallel import fsdp
from ..parallel import tensor_parallel as TP
from ..utils.remat import check_policy, remat_call
from .common import from_numpy

BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336          # SwiGLU inner dim
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights
    remat: bool = True               # recompute each block in backward
    # a jax.checkpoint_policies name (utils/remat.py), e.g.
    # "dots_with_no_batch_dims_saveable": the projections' outputs are
    # saved, the rest of the block recomputed; None = full recompute
    remat_policy: Optional[str] = None
    # > 0: loss_fn takes the cross entropy per vocab chunk, each chunk's
    # logits recomputed in the backward (chunked_next_token_xent); the
    # vocab must divide evenly, or the dense path is used
    xent_chunks: int = 0

    def __post_init__(self):
        check_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size: int = 256, seq: int = 128) -> "LlamaConfig":
        """Test-scale config: same code path, toy sizes."""
        return LlamaConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                           n_heads=4, n_kv_heads=2, hidden_dim=128,
                           max_seq_len=seq, remat=False)

    @staticmethod
    def small(vocab_size: int = 32000) -> "LlamaConfig":
        """~125M config: 12 layers, dim 768, 6 heads of 128, 2 KV heads."""
        return LlamaConfig(vocab_size=vocab_size, dim=768, n_layers=12,
                           n_heads=6, n_kv_heads=2, hidden_dim=2048,
                           max_seq_len=2048)


def param_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    d, h, L = cfg.dim, cfg.hidden_dim, cfg.n_layers
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "attn_norm": (L, d),
            "wq": (L, d, nh * hd),
            "wk": (L, d, nkv * hd),
            "wv": (L, d, nkv * hd),
            "wo": (L, nh * hd, d),
            "mlp_norm": (L, d),
            "w_gate": (L, d, h),
            "w_up": (L, d, h),
            "w_down": (L, h, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's scales: norms 1, dense
    leaves N(0, 1/fan_in), the embedding N(0, 0.02^2). Draws come from
    ``generator``, which lives on ``device``."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)

    def dense(shape, scale=None):
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
        scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=cfg.param_dtype) * scale

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=device)

    blk = shapes["blocks"]
    return {
        "embed": dense(shapes["embed"], scale=0.02),
        "blocks": {k: (ones(s) if k.endswith("norm") else dense(s))
                   for k, s in blk.items()},
        "final_norm": ones(shapes["final_norm"]),
        "lm_head": dense(shapes["lm_head"]),
    }


def params_from_jax(tree: Dict[str, Any], device=None,
                    dtype: torch.dtype = torch.float32, mesh=None,
                    specs=None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, as nested dicts of numpy
    arrays, to tensors on ``device`` (names and layout are the same);
    with ``mesh``, this rank's slice of each leaf by ``specs`` (e.g.
    ``sharding.llama_param_specs()``, or ``fsdp_param_specs`` over it)."""
    return from_numpy(tree, device, dtype, mesh=mesh, specs=specs)


class Llama(nn.Module):
    """The parameters of a Llama model, as ``nn.Parameter`` leaves with the
    JAX names: ``embed``, ``blocks.<leaf>``, ``final_norm``, ``lm_head``.
    ``params()`` gives the nested dict that the functions below take."""

    def __init__(self, cfg: LlamaConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if params is None:
            if generator is None:
                raise ValueError("Llama needs a seeded torch.Generator or "
                                 "explicit params")
            params = init_params(cfg, generator, device)
        shapes = param_shapes(cfg)

        def as_param(x, shape, name):
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                                 f"{tuple(shape)}")
            return nn.Parameter(x.to(device=device, dtype=cfg.param_dtype))

        self.embed = as_param(params["embed"], shapes["embed"], "embed")
        self.blocks = nn.ParameterDict({
            k: as_param(params["blocks"][k], shapes["blocks"][k],
                        f"blocks/{k}") for k in BLOCK_KEYS})
        self.final_norm = as_param(params["final_norm"],
                                   shapes["final_norm"], "final_norm")
        self.lm_head = as_param(params["lm_head"], shapes["lm_head"],
                                "lm_head")

    def params(self) -> Dict[str, Any]:
        return {"embed": self.embed,
                "blocks": {k: self.blocks[k] for k in BLOCK_KEYS},
                "final_norm": self.final_norm, "lm_head": self.lm_head}

    def forward(self, tokens: torch.Tensor, attn_impl=None) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg, attn_impl)


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #

def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def rope_cache(cfg: LlamaConfig, seq_len: int, device, offset: int = 0):
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2) / hd))
    t = np.arange(offset, offset + seq_len)
    freqs = np.outer(t, inv_freq)                      # [S, hd/2], float64
    return (torch.as_tensor(np.cos(freqs), dtype=torch.float32).to(device),
            torch.as_tensor(np.sin(freqs), dtype=torch.float32).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; rotate the two halves."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[None, :, None, :].to(x.dtype)
    sin = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, cfg: LlamaConfig, attn_impl=None):
    """Causal GQA attention, q [B,S,nh,hd], k/v [B,S,nkv,hd]; dense unless
    ``attn_impl`` is given (e.g. ``make_flash_attn()``)."""
    if attn_impl is not None:
        return attn_impl(q, k, v)
    B, S, nh, hd = q.shape
    groups = nh // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / np.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -1e30, dtype=logits.dtype,
                                    device=q.device))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attn_sublayer(x, p, cos, sin, cfg: LlamaConfig, attn_impl=None,
                  tp_axis: Optional[str] = None):
    """Pre-norm attention with residual: x + Attn(RMSNorm(x)). Under
    ``tp_axis`` the rank attends over its n_heads / tp query heads and
    n_kv_heads / tp KV heads."""
    B, S, d = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    if tp_axis is not None:
        n = TP.check_heads(nh, nkv, tp_axis)
        nh, nkv = nh // n, nkv // n
    h = _rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = TP.column_parallel(
        h, [p[w].to(dt) for w in ("wq", "wk", "wv")], tp_axis)
    q = apply_rope(q.reshape(B, S, nh, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, nkv, hd), cos, sin)
    v = v.reshape(B, S, nkv, hd)
    attn = _attention(q, k, v, cfg, attn_impl)
    return x + TP.row_parallel(attn.reshape(B, S, nh * hd), p["wo"].to(dt),
                               tp_axis)


def _block(x, p, cos, sin, cfg: LlamaConfig, attn_impl=None,
           tp_axis: Optional[str] = None):
    """One decoder block; ``p`` holds this layer's (unstacked) params."""
    dt = cfg.dtype
    x = attn_sublayer(x, p, cos, sin, cfg, attn_impl, tp_axis)
    h = _rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    gate, up = TP.column_parallel(
        h, [p["w_gate"].to(dt), p["w_up"].to(dt)], tp_axis)
    return x + TP.row_parallel(F.silu(gate) * up, p["w_down"].to(dt),
                               tp_axis)


def next_token_xent(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, logsumexp form in f32."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def chunked_next_token_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                            targets: torch.Tensor,
                            n_chunks: int) -> torch.Tensor:
    """Mean next-token cross entropy without the [B, S, V] logits: per
    vocab chunk, ``hidden @ W_c`` in ``hidden``'s dtype, cast to f32, its
    logsumexp and the target's logit (-inf where the target lies in
    another chunk), under a checkpoint that saves nothing, so the chunk's
    logits are recomputed in the backward; the chunks combine by a
    logsumexp of their logsumexps and a max of their picks (the target
    lies in exactly one). Port of byteps_tpu/models/llama.py:214-251."""
    V = lm_head.shape[1]
    Vc = V // n_chunks
    targets = targets.long()

    def chunk_lse_pick(h, wc, base):
        logits = (h @ wc.to(h.dtype)).to(torch.float32)       # [B, S, Vc]
        lse_c = torch.logsumexp(logits, dim=-1)
        inrange = (targets >= base) & (targets < base + Vc)
        loc = torch.clamp(targets - base, 0, Vc - 1)
        picked = torch.gather(logits, -1, loc[..., None])[..., 0]
        return lse_c, torch.where(inrange, picked,
                                  torch.full((), float("-inf"),
                                             device=picked.device))

    lses, picks = [], []
    for c in range(n_chunks):
        wc = lm_head[:, c * Vc:(c + 1) * Vc]
        if torch.is_grad_enabled():
            lse_c, pick_c = checkpoint(chunk_lse_pick, hidden, wc, c * Vc,
                                       use_reentrant=False)
        else:
            lse_c, pick_c = chunk_lse_pick(hidden, wc, c * Vc)
        lses.append(lse_c)
        picks.append(pick_c)
    lse = torch.logsumexp(torch.stack(lses, 0), dim=0)
    picked = torch.amax(torch.stack(picks, 0), dim=0)
    return torch.mean(lse - picked)


def split_batch(batch: Dict[str, torch.Tensor]) -> tuple:
    """(inputs, targets) from a pre-shifted {'inputs','targets'} batch or
    a raw {'tokens'} batch (shifted here)."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"]
    return batch["tokens"][:, :-1], batch["tokens"][:, 1:]


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: LlamaConfig, attn_impl=None,
                   sp_axis: Optional[str] = None,
                   tp_axis: Optional[str] = None) -> torch.Tensor:
    """tokens [B, S] -> final normed hidden [B, S, d] in cfg.dtype.

    ``sp_axis``: with the sequence split over that mesh axis (inside
    ``with mesh:``), RoPE takes global positions, this rank's chunk
    starting at axis_index * S, and the attention defaults to ring
    attention over the axis (local attention would never cross a
    shard's border).

    ``tp_axis``: with the leaves split over that axis as
    ``sharding.llama_param_specs`` lays them out, the embedding is
    vocab-parallel and each block attends over this rank's heads (its
    ``attn_impl`` too, e.g. the flash kernel at [B, S, n_heads / tp,
    hd]); the hidden state comes out whole on every rank. It composes
    with ``sp_axis``."""
    B, S = tokens.shape
    embed = fsdp.whole(params["embed"])
    if tp_axis is not None:
        x = TP.vocab_parallel_embed(embed, tokens, tp_axis, cfg.dtype)
    else:
        x = embed.to(cfg.dtype)[tokens.long()]
    if sp_axis is not None:
        from ..parallel.collectives import axis_index
        if attn_impl is None:
            from ..parallel.ring_attention import make_ring_attn
            attn_impl = make_ring_attn(axis=sp_axis, causal=True)
        cos, sin = rope_cache(cfg, S, x.device,
                              offset=axis_index(sp_axis) * S)
    else:
        cos, sin = rope_cache(cfg, S, x.device)
    x = _layers(x, params["blocks"], cos, sin, cfg, attn_impl, tp_axis)
    return _rmsnorm(x, fsdp.whole(params["final_norm"]), cfg.norm_eps)


def _layer(x, blk, layer: int, cos, sin, cfg: LlamaConfig, attn_impl=None,
           tp_axis: Optional[str] = None):
    """Block ``layer`` of the stacked ``blk``, its leaves taken here, so
    that under a checkpoint an FSDP leaf's gather is redone in the
    recompute and its gathered copy is not kept."""
    p = {k: fsdp.layer(v, layer) for k, v in blk.items()}
    return _block(x, p, cos, sin, cfg, attn_impl, tp_axis)


def _layers(x, blk, cos, sin, cfg: LlamaConfig, attn_impl=None,
            tp_axis: Optional[str] = None):
    """The stacked blocks ``blk`` (leading dim: layers) over x, each
    recomputed in the backward under ``cfg.remat``."""
    fn = functools.partial(_layer, cfg=cfg, attn_impl=attn_impl,
                           tp_axis=tp_axis)
    for layer in range(blk["wq"].shape[0]):
        if cfg.remat and torch.is_grad_enabled():
            x = remat_call(fn, x, blk, layer, cos, sin,
                           policy=cfg.remat_policy)
        else:
            x = fn(x, blk, layer, cos, sin)
    return x


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            attn_impl=None, sp_axis: Optional[str] = None,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] in cfg.dtype (``sp_axis``:
    see ``forward_hidden``); under ``tp_axis``, the logits of this
    rank's vocab slice [B, S, vocab / tp]."""
    x = forward_hidden(params, tokens, cfg, attn_impl, sp_axis, tp_axis)
    head = fsdp.whole(params["lm_head"]).to(cfg.dtype)
    (logits,) = TP.column_parallel(x, [head], tp_axis)
    return logits


def forward_pp(params: Dict[str, Any], tokens: torch.Tensor,
               cfg: LlamaConfig, *, num_microbatches: int,
               pp_axis: str = "pp") -> torch.Tensor:
    """Pipeline-parallel forward, inside ``with mesh:``, with
    ``params["blocks"]`` this stage's n_layers / P layers
    (``parallel.sharding.llama_pp_param_specs``) and the rest whole.
    Returns logits valid ONLY on the last stage (zeros elsewhere). The
    blocks take the dense attention, as JAX's do."""
    from ..parallel.pipeline import pipeline_forward

    B, S = tokens.shape
    cos, sin = rope_cache(cfg, S, params["embed"].device)
    x = params["embed"].to(cfg.dtype)[tokens.long()]

    def layer_fn(h, p_layer):
        return _block(h, p_layer, cos, sin, cfg, None)

    out = pipeline_forward(x, params["blocks"], layer_fn,
                           num_microbatches=num_microbatches, axis=pp_axis,
                           remat=cfg.remat)
    h = _rmsnorm(out, params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"].to(cfg.dtype)


def loss_fn_pp(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: LlamaConfig, *, num_microbatches: int,
               pp_axis: str = "pp") -> torch.Tensor:
    """Pipeline-parallel next-token loss, the same on every stage.

    Gradients: the blocks' come out for this stage's layers; those of
    the replicated leaves (embed, final_norm, lm_head) are each stage's
    part, to be summed over ``pp_axis``
    (``parallel.pipeline.replicated_grad_correction``)."""
    from ..parallel.pipeline import last_stage_value

    inputs, targets = split_batch(batch)
    logits = forward_pp(params, inputs, cfg,
                        num_microbatches=num_microbatches, pp_axis=pp_axis)
    return last_stage_value(next_token_xent(logits, targets), pp_axis)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig, attn_impl=None,
            sp_axis: Optional[str] = None,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy of {'tokens': [B, S+1]} or a pre-shifted
    {'inputs', 'targets'} batch (required under ``sp_axis``, where the
    shift must happen before the split); per vocab chunk when
    ``cfg.xent_chunks`` divides the vocab. Under ``sp_axis`` the loss is
    the mean over the axis (``pmean``): each rank's gradient then is its
    own part, and their mean is the gradient of the whole. Under
    ``tp_axis`` the cross entropy is vocab-parallel
    (``tensor_parallel.vocab_parallel_xent``), the loss the same on every
    rank of the axis, and each rank's gradients those of its slices;
    ``xent_chunks`` there is not ported (a ValueError)."""
    if "inputs" not in batch and sp_axis is not None:
        raise ValueError(
            "sequence parallelism requires a pre-shifted batch "
            "({'inputs', 'targets'}): shifting a sharded 'tokens' "
            "locally would gap the global sequence")
    chunked = cfg.xent_chunks > 0 and cfg.vocab_size % cfg.xent_chunks == 0
    if chunked and tp_axis is not None:
        raise ValueError("xent_chunks under tp_axis is not ported: the "
                         "chunked cross entropy takes the whole vocab")
    inputs, targets = split_batch(batch)
    if chunked:
        hidden = forward_hidden(params, inputs, cfg, attn_impl, sp_axis)
        loss = chunked_next_token_xent(hidden, fsdp.whole(params["lm_head"]),
                                       targets, cfg.xent_chunks)
    elif tp_axis is not None:
        logits = forward(params, inputs, cfg, attn_impl, sp_axis, tp_axis)
        loss = torch.mean(TP.vocab_parallel_xent(logits, targets, tp_axis))
    else:
        loss = next_token_xent(forward(params, inputs, cfg, attn_impl,
                                       sp_axis), targets)
    if sp_axis is not None:
        from ..parallel.collectives import pmean
        loss = pmean(loss, sp_axis)
    return loss
