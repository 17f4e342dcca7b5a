"""ResNet (v1.5) for image classification, in PyTorch.

Port of byteps_tpu/models/resnet.py with its leaf names, shapes and
numerics: ``stem_conv`` HWIO [7, 7, 3, width], ``stem_bn`` {scale,
bias}, blocks ``s{stage}b{block}`` of bottlenecks (``conv1`` 1×1,
``conv2`` 3×3 with the stage's stride, ``conv3`` 1×1, each with its
``bn``; a ``proj`` 1×1 conv and ``proj_bn`` where cin != cout or the
block is its stage's first), ``fc_w`` [C, n_classes], ``fc_b``. f32
master weights, compute in ``cfg.dtype`` (bf16); the head in f32.

Written out where torch's own layers round otherwise:

- batch norm (``_batchnorm``): statistics in f32 over (N, H, W), the
  biased variance for normalising and for the running state, the update
  ``m·old + (1-m)·batch``; the normalised value cast to the compute
  dtype, then scaled and shifted in it (``nn.BatchNorm2d`` keeps the
  unbiased variance in its running state);
- the stem's 3×3 stride-2 max pool pads as XLA's "SAME" does, the
  smaller half before (``same_pool_pad``), with -inf: at an even size
  that is 0 before and 1 after, not torch's symmetric ``padding=1``;
- convs pad (k-1)//2 each side for k > 1, none for 1×1.

The batch-norm state is a second tree (``init_params`` returns
``(params, bn_state)``); ``forward`` and ``loss_fn`` return the new
state beside their output. ``ResNet`` keeps the state in buffers, never
among the parameters, so the PS keys are the parameters' alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.state import resolve_device
from .common import (ParamTree, check_shapes, from_numpy,  # noqa: F401
                     module_params, param_count, softmax_xent, tree_map)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    width: int = 64
    n_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def resnet18() -> "ResNetConfig":
        # the JAX preset: bottlenecks at (2, 2, 2, 2), not basic blocks
        return ResNetConfig(stage_sizes=(2, 2, 2, 2))

    @staticmethod
    def tiny(n_classes: int = 10) -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), width=16, n_classes=n_classes)


def _blocks(cfg: ResNetConfig):
    """(name, cin, cmid, cout, stride, has_proj) of every block."""
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** s)
        cout = cmid * 4
        for b in range(n_blocks):
            yield (f"s{s}b{b}", cin, cmid, cout,
                   2 if (s > 0 and b == 0) else 1, cin != cout or b == 0)
            cin = cout


def param_shapes(cfg: ResNetConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(parameter shapes, batch-norm state shapes)."""
    def bn(c):
        return {"scale": (c,), "bias": (c,)}

    def st(c):
        return {"mean": (c,), "var": (c,)}

    params: Dict[str, Any] = {"stem_conv": (7, 7, 3, cfg.width),
                              "stem_bn": bn(cfg.width)}
    state: Dict[str, Any] = {"stem_bn": st(cfg.width)}
    cout = cfg.width
    for name, cin, cmid, cout, _, proj in _blocks(cfg):
        blk = {"conv1": (1, 1, cin, cmid), "bn1": bn(cmid),
               "conv2": (3, 3, cmid, cmid), "bn2": bn(cmid),
               "conv3": (1, 1, cmid, cout), "bn3": bn(cout)}
        bst = {"bn1": st(cmid), "bn2": st(cmid), "bn3": st(cout)}
        if proj:
            blk["proj"] = (1, 1, cin, cout)
            blk["proj_bn"] = bn(cout)
            bst["proj_bn"] = st(cout)
        params[name], state[name] = blk, bst
    params["fc_w"] = (cout, cfg.n_classes)
    params["fc_b"] = (cfg.n_classes,)
    return params, state


def _initial_state(sshapes, device):
    """Running means 0 and variances 1 (f32)."""
    def st(node):
        if "mean" in node:
            return {"mean": torch.zeros(node["mean"], device=device),
                    "var": torch.ones(node["var"], device=device)}
        return {k: st(v) for k, v in node.items()}
    return st(sshapes)


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) with the JAX scales: convs N(0, 2/fan_in), BN
    scale 1 and bias 0, ``fc_w`` N(0, 0.01²), ``fc_b`` 0; running mean 0,
    variance 1."""
    device = resolve_device(device)
    pshapes, sshapes = param_shapes(cfg)
    pd = cfg.param_dtype

    def leaf(path, shape):
        if len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            return torch.randn(shape, generator=generator, device=device,
                               dtype=pd) * np.sqrt(2.0 / fan_in)
        if path == "fc_w":
            return torch.randn(shape, generator=generator, device=device,
                               dtype=pd) * 0.01
        fill = 1.0 if path.endswith("scale") else 0.0
        return torch.full(shape, fill, dtype=pd, device=device)

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return leaf(path, node)

    return walk(pshapes), _initial_state(sshapes, device)


def params_from_jax(tree, device=None, cfg: Optional[ResNetConfig] = None):
    """The JAX ``(params, bn_state)`` pair (or the params alone), numpy
    leaves, as f32 tensors on ``device``; shapes checked against ``cfg``
    when given."""
    shapes = param_shapes(cfg) if cfg is not None else (None, None)
    if isinstance(tree, tuple):
        return (from_numpy(tree[0], device, torch.float32, shapes[0]),
                from_numpy(tree[1], device, torch.float32, shapes[1]))
    return from_numpy(tree, device, torch.float32, shapes[0])


class ResNet(ParamTree):
    """ResNet's parameters as ``nn.Parameter`` leaves under the JAX names
    (``s0b0.conv1``, ``stem_bn.scale``, ...) and its batch-norm state as
    buffers beside them (``s0b0.bn1.mean``). ``params()`` and ``state()``
    are the two nested dicts ``forward`` takes."""

    def __init__(self, cfg: ResNetConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None,
                 state: Optional[Dict[str, Any]] = None):
        pshapes, sshapes = param_shapes(cfg)
        if params is None and generator is not None:
            params, state = init_params(cfg, generator, device)
        params = module_params("ResNet", cfg, pshapes, None, device, None,
                               params, cfg.param_dtype)
        dev = params["fc_b"].device
        if state is None:
            state = _initial_state(sshapes, dev)
        check_shapes(state, sshapes)
        super().__init__(params, tree_map(
            lambda x: x.detach().to(device=dev, dtype=torch.float32), state))
        self.cfg = cfg

    def state(self) -> Dict[str, Any]:
        return self.buffer_tree()

    def forward(self, x: torch.Tensor, train: bool = True):
        return forward(self.params(), self.state(), x, self.cfg, train)


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #

def _chan(v: torch.Tensor) -> torch.Tensor:
    """A per-channel [C] vector broadcast over NCHW."""
    return v[:, None, None]


def _batchnorm(x, p, st, cfg: ResNetConfig, train: bool):
    """(y, new_state); batch statistics in train mode."""
    xf = x.to(torch.float32)
    if train:
        mean = torch.mean(xf, dim=(0, 2, 3))
        var = torch.mean(torch.square(xf - _chan(mean)), dim=(0, 2, 3))
        m = cfg.bn_momentum
        new_st = {"mean": m * st["mean"] + (1 - m) * mean,
                  "var": m * st["var"] + (1 - m) * var}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    inv = torch.rsqrt(var + cfg.bn_eps)
    y = (xf - _chan(mean)) * _chan(inv)
    y = y.to(x.dtype) * _chan(p["scale"].to(x.dtype)) + \
        _chan(p["bias"].to(x.dtype))
    return y, new_st


def _conv(x, w, stride: int = 1):
    """An HWIO weight over NCHW x: (k-1)//2 each side, none for 1×1."""
    k = w.shape[0]
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=(k - 1) // 2)


def same_pool_pad(n: int, window: int = 3, stride: int = 2) -> Tuple[int,
                                                                   int]:
    """(before, after) of XLA's "SAME" padding of one spatial dim."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def stem_pool(h: torch.Tensor) -> torch.Tensor:
    """The stem's 3×3 stride-2 "SAME" max pool of NCHW h, padded with
    -inf as XLA pads it."""
    top, bottom = same_pool_pad(h.shape[2])
    left, right = same_pool_pad(h.shape[3])
    h = F.pad(h, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(h, 3, 2)


def forward(params, state, x: torch.Tensor, cfg: ResNetConfig,
            train: bool = True):
    """x [B, H, W, 3] -> (logits [B, n_classes] f32, new_bn_state)."""
    dt = cfg.dtype
    x = x.to(dt).permute(0, 3, 1, 2)           # NCHW view, channels_last
    new_state: Dict[str, Any] = {}

    h = _conv(x, params["stem_conv"], stride=2)
    h, new_state["stem_bn"] = _batchnorm(h, params["stem_bn"],
                                         state["stem_bn"], cfg, train)
    h = stem_pool(F.relu(h))

    for name, _, _, _, stride, _ in _blocks(cfg):
        blk, st = params[name], state[name]
        nst = {}
        y = _conv(h, blk["conv1"])
        y, nst["bn1"] = _batchnorm(y, blk["bn1"], st["bn1"], cfg, train)
        y = F.relu(y)
        y = _conv(y, blk["conv2"], stride=stride)
        y, nst["bn2"] = _batchnorm(y, blk["bn2"], st["bn2"], cfg, train)
        y = F.relu(y)
        y = _conv(y, blk["conv3"])
        y, nst["bn3"] = _batchnorm(y, blk["bn3"], st["bn3"], cfg, train)
        if "proj" in blk:
            sc = _conv(h, blk["proj"], stride=stride)
            sc, nst["proj_bn"] = _batchnorm(sc, blk["proj_bn"],
                                            st["proj_bn"], cfg, train)
        else:
            sc = h
        h = F.relu(y + sc)
        new_state[name] = nst

    h = torch.mean(h.to(torch.float32), dim=(2, 3))
    logits = h @ params["fc_w"].to(torch.float32) + \
        params["fc_b"].to(torch.float32)
    return logits, new_state


def loss_fn(params, state, batch: Dict[str, torch.Tensor],
            cfg: ResNetConfig):
    """(mean cross entropy, new_bn_state) of {'x': [B, H, W, 3],
    'y': [B]} with batch statistics."""
    logits, new_state = forward(params, state, batch["x"], cfg, train=True)
    return softmax_xent(logits, batch["y"]), new_state
