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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.state import resolve_device
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
                    cfg: Optional[BertConfig] = None) -> Dict[str, Any]:
    """The JAX parameter dict (numpy leaves) as f32 tensors on
    ``device``, its shapes checked against ``cfg`` when given."""
    return from_numpy(tree, device, torch.float32,
                      param_shapes(cfg) if cfg is not None else None)


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


def _block(x, p, mask, cfg: BertConfig):
    """One encoder layer; ``p`` holds this layer's (unstacked) params."""
    B, S, d = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype

    q = (x @ p["wq"].to(dt) + p["bq"].to(dt)).reshape(B, S, nh, hd)
    k = (x @ p["wk"].to(dt) + p["bk"].to(dt)).reshape(B, S, nh, hd)
    v = (x @ p["wv"].to(dt) + p["bv"].to(dt)).reshape(B, S, nh, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full((), -1e30, dtype=logits.dtype,
                                        device=logits.device))
    probs = torch.softmax(logits.to(torch.float32), -1).to(dt)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, d)
    attn = attn @ p["wo"].to(dt) + p["bo"].to(dt)
    x = _layernorm(x + attn, p["ln1_g"], p["ln1_b"], cfg.norm_eps)

    h = _gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt))
    h = h @ p["w_out"].to(dt) + p["b_out"].to(dt)
    return _layernorm(x + h, p["ln2_g"], p["ln2_b"], cfg.norm_eps)


def forward(params, tokens: torch.Tensor, cfg: BertConfig, type_ids=None,
            attn_mask=None) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, d] (compute dtype)."""
    B, S = tokens.shape
    dt = cfg.dtype
    x = params["tok_embed"].to(dt)[tokens.long()]
    x = x + params["pos_embed"].to(dt)[None, :S]
    if type_ids is not None:
        x = x + params["type_embed"].to(dt)[type_ids.long()]
    x = _layernorm(x, params["embed_ln_g"], params["embed_ln_b"],
                   cfg.norm_eps)
    blk = params["blocks"]
    for layer in range(cfg.n_layers):
        p = {k: v[layer] for k, v in blk.items()}
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_block, x, p, attn_mask, cfg, use_reentrant=False)
        else:
            x = _block(x, p, attn_mask, cfg)
    return x


def mlm_logits(params, hidden: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """[B, S, d] hidden -> [B, S, V] f32 logits (tied to ``tok_embed``)."""
    dt = cfg.dtype
    h = _gelu(hidden @ params["mlm_dense"].to(dt)
              + params["mlm_bias"].to(dt))
    h = _layernorm(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.norm_eps)
    logits = h @ params["tok_embed"].to(dt).T + \
        params["mlm_out_bias"].to(dt)
    return logits.to(torch.float32)


def loss_fn(params, batch: Dict[str, torch.Tensor],
            cfg: BertConfig) -> torch.Tensor:
    """Masked-LM loss of {'tokens': [B, S], 'labels': [B, S]} (labels < 0
    are unmasked), with an optional bool 'attn_mask' [B, S]."""
    hidden = forward(params, batch["tokens"], cfg,
                     attn_mask=batch.get("attn_mask"))
    logits = mlm_logits(params, hidden, cfg)
    labels = batch["labels"].long()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - picked) * valid
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
