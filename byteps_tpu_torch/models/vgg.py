"""VGG for image classification, in PyTorch.

Port of byteps_tpu/models/vgg.py with its leaf names, shapes and
numerics: ``conv{i}`` {``w`` HWIO [3, 3, cin, cout], ``b``} at the
plan's index i, ``fc{j}`` {``w`` [in, out], ``b``}; f32 master weights,
compute in ``cfg.dtype`` (bf16); 3×3 convs padded SAME (one pixel each
side), 2×2 VALID max pools, the bias added in the compute dtype before
the ReLU; logits in f32.

The input is NHWC as in the JAX model; ``x.permute(0, 3, 1, 2)`` is a
channels_last NCHW view of it, and an HWIO weight enters ``F.conv2d``
as ``w.permute(3, 2, 0, 1)``, so no layout is copied by hand and each
gradient lands in its JAX layout. The flatten before ``fc0`` runs over
(H, W, C), as the JAX model's NHWC reshape does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.state import resolve_device
from .common import (ParamTree, from_numpy, module_params,  # noqa: F401
                     param_count, softmax_xent)


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    # channels per conv layer, "M" = 2x2 max-pool (torchvision config "D")
    plan: Tuple[Any, ...] = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                             512, 512, 512, "M", 512, 512, 512, "M")
    fc_width: int = 4096
    n_classes: int = 1000
    image_size: int = 224
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def vgg16() -> "VGGConfig":
        return VGGConfig()

    @staticmethod
    def vgg11() -> "VGGConfig":
        return VGGConfig(plan=(64, "M", 128, "M", 256, 256, "M",
                               512, 512, "M", 512, 512, "M"))

    @staticmethod
    def tiny(n_classes: int = 10) -> "VGGConfig":
        return VGGConfig(plan=(16, "M", 32, "M"), fc_width=64,
                         n_classes=n_classes, image_size=32)


def param_shapes(cfg: VGGConfig) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    cin = 3
    for i, c in enumerate(cfg.plan):
        if c == "M":
            continue
        out[f"conv{i}"] = {"w": (3, 3, cin, c), "b": (c,)}
        cin = c
    # spatial extent after the pools (224 -> 7 for the full plan)
    spatial = cfg.image_size // (2 ** sum(1 for c in cfg.plan if c == "M"))
    flat = cin * spatial * spatial
    for j, (fin, fout) in enumerate(
            [(flat, cfg.fc_width), (cfg.fc_width, cfg.fc_width),
             (cfg.fc_width, cfg.n_classes)]):
        out[f"fc{j}"] = {"w": (fin, fout), "b": (fout,)}
    return out


def init_params(cfg: VGGConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """He-normal weights (N(0, 2/fan_in), fan_in = 9·cin for a conv),
    zero biases: the JAX scales."""
    device = resolve_device(device)
    out = {}
    for name, leaf in param_shapes(cfg).items():
        w = leaf["w"]
        fan_in = w[0] * w[1] * w[2] if len(w) == 4 else w[0]
        out[name] = {
            "w": torch.randn(w, generator=generator, device=device,
                             dtype=cfg.param_dtype) * np.sqrt(2.0 / fan_in),
            "b": torch.zeros(leaf["b"], dtype=cfg.param_dtype,
                             device=device)}
    return out


def params_from_jax(tree: Dict[str, Any], device=None,
                    cfg: Optional[VGGConfig] = None) -> Dict[str, Any]:
    """The JAX parameter dict (numpy leaves) as f32 tensors on
    ``device``, its shapes checked against ``cfg`` when given."""
    return from_numpy(tree, device, torch.float32,
                      param_shapes(cfg) if cfg is not None else None)


class VGG(ParamTree):
    """VGG's parameters as ``nn.Parameter`` leaves under the JAX names
    (``conv0.w``, ``fc0.b``, ...); ``params()`` is the nested dict."""

    def __init__(self, cfg: VGGConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(module_params("VGG", cfg, param_shapes(cfg),
                                       init_params, device, generator,
                                       params, cfg.param_dtype))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x, self.cfg)


def forward(params, x: torch.Tensor, cfg: VGGConfig) -> torch.Tensor:
    """x [B, H, W, 3] -> logits [B, n_classes] f32."""
    dt = cfg.dtype
    h = x.to(dt).permute(0, 3, 1, 2)           # NCHW view, channels_last
    for i, c in enumerate(cfg.plan):
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        p = params[f"conv{i}"]
        h = F.conv2d(h, p["w"].to(dt).permute(3, 2, 0, 1), padding=1)
        h = F.relu(h + p["b"].to(dt)[:, None, None])
    # the JAX flatten runs over NHWC: (H, W, C) order into fc0
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for j in range(3):
        p = params[f"fc{j}"]
        h = h @ p["w"].to(dt) + p["b"].to(dt)
        if j < 2:
            h = F.relu(h)
    return h.to(torch.float32)


def loss_fn(params, batch: Dict[str, torch.Tensor],
            cfg: VGGConfig) -> torch.Tensor:
    """Mean cross entropy of {'x': [B, H, W, 3], 'y': [B]}."""
    return softmax_xent(forward(params, batch["x"], cfg), batch["y"])
