"""BERT encoder with the masked-LM objective, in PyTorch.

Port of byteps_tpu/models/bert.py with its leaf names, shapes and
numerics: ``tok_embed`` [V, d], ``pos_embed`` [S_max, d], ``type_embed``
[2, d], the embedding LayerNorm, ``blocks`` with every leaf stacked on a
leading [n_layers] dim (``wq`` [L, d, d], ``bq`` [L, d], ... ``w_in`` [L,
d, ffn], ``w_out`` [L, ffn, d], the two LayerNorms), and the MLM head
(``mlm_dense``, ``mlm_bias``, its LayerNorm, ``mlm_out_bias``; the
output projection is ``tok_embed`` transposed). f32 master weights,
compute in ``cfg.dtype`` (bf16), post-LN residuals.

Written out where torch's own ops round otherwise:

- ``_layernorm`` normalises in f32 with the biased variance and
  ``rsqrt(var + eps)``, casts, then applies the gain and bias in the
  compute dtype (``F.layer_norm`` applies them before its cast);
- GELU is the tanh approximation (``jax.nn.gelu``'s default);
- masked logits are -1e30, the softmax runs in f32; the MLM logits are
  f32, the loss the logsumexp form over the positions with label >= 0.

``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` does.
Without ``type_ids`` the ``type_embed`` leaf takes no part and gets no
gradient; the train steps push zeros for it, as the JAX step does.

``tp_axis`` runs it Megatron-parallel over a mesh axis, the leaves split
as ``sharding.bert_param_specs`` lays them out
(``parallel/tensor_parallel.py``): heads, the FFN's inner dim and the
vocab split, the rest replicated. Three spots that the JAX tables leave
to XLA:

- ``bq``, ``bk``, ``bv``, ``b_in`` and ``mlm_bias`` are replicated while
  their products' columns are split: each rank adds its slice
  (``collectives.scatter_to``), whose backward gathers the ranks'
  slices, so every rank's gradient of the leaf is the whole one (the sum
  over the axis of the slices' gradients, each nonzero on its own);
- ``mlm_dense`` is column-split but ``mlm_ln`` normalizes over the whole
  d: its output is gathered (``gather_from``) before the LayerNorm;
- the logits use the vocab-split ``tok_embed`` tied, plus this rank's
  slice of the replicated ``mlm_out_bias``: vocab-parallel logits, whose
  cross entropy is ``vocab_parallel_xent``.

A leaf may also be an FSDP ``parallel.fsdp.Sharded`` (``spmd.py`` hands
the leaves split over ``dp`` so), gathered where it is used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.state import resolve_device
from ..parallel import fsdp
from ..parallel import tensor_parallel as TP
from ..parallel.collectives import gather_from, scatter_to
from .common import (ParamTree, from_numpy, module_params,  # noqa: F401
                     param_count)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    max_seq_len: int = 512
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def bert_large() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def bert_base() -> "BertConfig":
        return BertConfig(dim=768, n_layers=12, n_heads=12, ffn_dim=3072)

    @staticmethod
    def tiny(vocab_size: int = 256, seq: int = 64) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                          n_heads=4, ffn_dim=128, max_seq_len=seq,
                          remat=False)


def param_shapes(cfg: BertConfig) -> Dict[str, Any]:
    d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
    dd, vd = (L, d, d), (L, d)
    blocks = {"wq": dd, "bq": vd, "wk": dd, "bk": vd, "wv": dd, "bv": vd,
              "wo": dd, "bo": vd, "ln1_g": vd, "ln1_b": vd,
              "w_in": (L, d, f), "b_in": (L, f), "w_out": (L, f, d),
              "b_out": vd, "ln2_g": vd, "ln2_b": vd}
    return {
        "tok_embed": (cfg.vocab_size, d),
        "pos_embed": (cfg.max_seq_len, d),
        "type_embed": (cfg.type_vocab, d),
        "embed_ln_g": (d,), "embed_ln_b": (d,),
        "blocks": blocks,
        "mlm_dense": (d, d), "mlm_bias": (d,),
        "mlm_ln_g": (d,), "mlm_ln_b": (d,),
        "mlm_out_bias": (cfg.vocab_size,),
    }


def init_params(cfg: BertConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """The JAX scales: matrices and embeddings N(0, 0.02²), biases 0,
    LayerNorm gains 1."""
    device = resolve_device(device)
    pd = cfg.param_dtype

    def leaf(name, shape):
        if name.endswith("_g"):
            return torch.ones(shape, dtype=pd, device=device)
        if name.startswith("w") or name.endswith("embed") or \
                name == "mlm_dense":
            return torch.randn(shape, generator=generator, device=device,
                               dtype=pd) * 0.02
        return torch.zeros(shape, dtype=pd, device=device)

    return {k: ({kk: leaf(kk, s) for kk, s in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in param_shapes(cfg).items()}


def params_from_jax(tree: Dict[str, Any], device=None,
                    cfg: Optional[BertConfig] = None, mesh=None,
                    specs=None) -> Dict[str, Any]:
    """The JAX parameter dict (numpy leaves) as f32 tensors on
    ``device``, its shapes checked against ``cfg`` when given; with
    ``mesh``, this rank's slice of each leaf by ``specs`` (e.g.
    ``sharding.bert_param_specs()``)."""
    return from_numpy(tree, device, torch.float32,
                      param_shapes(cfg) if cfg is not None else None,
                      mesh=mesh, specs=specs)


class Bert(ParamTree):
    """BERT's parameters as ``nn.Parameter`` leaves under the JAX names
    (``tok_embed``, ``blocks.wq``, ...); ``params()`` is the nested
    dict."""

    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(module_params("Bert", cfg, param_shapes(cfg),
                                       init_params, device, generator,
                                       params, cfg.param_dtype))
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, type_ids=None,
                attn_mask=None) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg, type_ids, attn_mask)


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #

def _layernorm(x, g, b, eps: float):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * g.to(x.dtype) + b.to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _bias(b, dt, tp_axis):
    """A replicated bias in ``dt``: under ``tp_axis``, this rank's slice
    of it, for a column-parallel product's columns."""
    return (b if tp_axis is None else scatter_to(b, tp_axis)).to(dt)


def _block(x, p, mask, cfg: BertConfig, tp_axis: Optional[str] = None):
    """One encoder layer; ``p`` holds this layer's (unstacked) params.
    Under ``tp_axis``, over this rank's n_heads / tp heads."""
    B, S, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    if tp_axis is not None:
        nh //= TP.check_heads(nh, nh, tp_axis)

    q, k, v = TP.column_parallel(
        x, [p[w].to(dt) for w in ("wq", "wk", "wv")], tp_axis)
    q = (q + _bias(p["bq"], dt, tp_axis)).reshape(B, S, nh, hd)
    k = (k + _bias(p["bk"], dt, tp_axis)).reshape(B, S, nh, hd)
    v = (v + _bias(p["bv"], dt, tp_axis)).reshape(B, S, nh, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=logits.device))
    probs = torch.softmax(logits.to(torch.float32), -1).to(dt)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, nh * hd)
    attn = TP.row_parallel(attn, p["wo"].to(dt), tp_axis) + p["bo"].to(dt)
    x = _layernorm(x + attn, p["ln1_g"], p["ln1_b"], cfg.norm_eps)

    (h,) = TP.column_parallel(x, [p["w_in"].to(dt)], tp_axis)
    h = _gelu(h + _bias(p["b_in"], dt, tp_axis))
    h = TP.row_parallel(h, p["w_out"].to(dt), tp_axis) + p["b_out"].to(dt)
    return _layernorm(x + h, p["ln2_g"], p["ln2_b"], cfg.norm_eps)


def _layer(x, blk, layer: int, mask, cfg: BertConfig,
           tp_axis: Optional[str] = None):
    """Layer ``layer`` of the stacked ``blk``, its leaves taken here, so
    that under a checkpoint an FSDP leaf's gather is redone in the
    recompute and its gathered copy is not kept."""
    p = {k: fsdp.layer(v, layer) for k, v in blk.items()}
    return _block(x, p, mask, cfg, tp_axis)


def forward(params, tokens: torch.Tensor, cfg: BertConfig, type_ids=None,
            attn_mask=None, tp_axis: Optional[str] = None) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, d] (compute dtype),
    whole on every rank of ``tp_axis`` (the embedding vocab-parallel). A
    leaf may be an FSDP ``parallel.fsdp.Sharded``, gathered where it is
    used (a layer's inside the layer's checkpoint)."""
    B, S = tokens.shape
    dt = cfg.dtype
    W = {k: v if k == "blocks" else fsdp.whole(v) for k, v in params.items()
         if k in ("tok_embed", "pos_embed", "type_embed", "embed_ln_g",
                  "embed_ln_b", "blocks")}
    if tp_axis is not None:
        x = TP.vocab_parallel_embed(W["tok_embed"], tokens, tp_axis, dt)
    else:
        x = W["tok_embed"].to(dt)[tokens.long()]
    x = x + W["pos_embed"].to(dt)[None, :S]
    if type_ids is not None:
        x = x + W["type_embed"].to(dt)[type_ids.long()]
    x = _layernorm(x, W["embed_ln_g"], W["embed_ln_b"], cfg.norm_eps)
    for layer in range(cfg.n_layers):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, W["blocks"], layer, attn_mask, cfg,
                           tp_axis, use_reentrant=False)
        else:
            x = _layer(x, W["blocks"], layer, attn_mask, cfg, tp_axis)
    return x


def mlm_logits(params, hidden: torch.Tensor, cfg: BertConfig,
               tp_axis: Optional[str] = None) -> torch.Tensor:
    """[B, S, d] hidden -> [B, S, V] f32 logits (tied to ``tok_embed``);
    under ``tp_axis``, those of this rank's vocab slice [B, S, V / tp]."""
    dt = cfg.dtype
    W = {k: fsdp.whole(params[k]) for k in (
        "mlm_dense", "mlm_bias", "mlm_ln_g", "mlm_ln_b", "tok_embed",
        "mlm_out_bias")}
    (h,) = TP.column_parallel(hidden, [W["mlm_dense"].to(dt)], tp_axis)
    h = _gelu(h + _bias(W["mlm_bias"], dt, tp_axis))
    if tp_axis is not None:
        h = gather_from(h, tp_axis)
    h = _layernorm(h, W["mlm_ln_g"], W["mlm_ln_b"], cfg.norm_eps)
    (logits,) = TP.column_parallel(h, [W["tok_embed"].to(dt).T], tp_axis)
    logits = logits + _bias(W["mlm_out_bias"], dt, tp_axis)
    return logits.to(torch.float32)


def loss_parts(params, batch: Dict[str, torch.Tensor], cfg: BertConfig,
               tp_axis: Optional[str] = None) -> tuple:
    """(the summed masked-LM loss, the count of masked positions) of
    {'tokens': [B, S], 'labels': [B, S]} (labels < 0 are unmasked), with
    an optional bool 'attn_mask' [B, S]: a batch split over ``dp``
    reaches the global loss by summing both over it
    (``spmd.make_spmd_train_step``)."""
    hidden = forward(params, batch["tokens"], cfg,
                     attn_mask=batch.get("attn_mask"), tp_axis=tp_axis)
    logits = mlm_logits(params, hidden, cfg, tp_axis)
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    if tp_axis is not None:
        nll = TP.vocab_parallel_xent(logits, safe, tp_axis)
    else:
        lse = torch.logsumexp(logits, -1)
        nll = lse - torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid), torch.sum(valid)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: BertConfig,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """Masked-LM loss: ``loss_parts``'s sum over its count (at least
    1)."""
    total, count = loss_parts(params, batch, cfg, tp_axis)
    return total / torch.clamp(count, min=1)
