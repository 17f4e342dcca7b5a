"""Small MLP classifier, the MNIST parity model, in PyTorch.

Port of byteps_tpu/models/mlp.py: leaves ``w{i}`` [in, out] and
``b{i}`` [out] as there (``x @ w + b``, not ``nn.Linear``), in
``cfg.dtype``; the loss is the mean cross entropy of the log-softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.state import resolve_device
from .common import ParamTree, from_numpy, module_params, softmax_xent


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (256, 128)
    n_classes: int = 10
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: MLPConfig) -> Dict[str, Any]:
    dims = [cfg.in_dim, *cfg.hidden, cfg.n_classes]
    out: Dict[str, Any] = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = (din, dout)
        out[f"b{i}"] = (dout,)
    return out


def init_params(cfg: MLPConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Weights N(0, 1/fan_in), biases 0 (the JAX scales)."""
    device = resolve_device(device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.startswith("w"):
            out[name] = torch.randn(shape, generator=generator,
                                    device=device,
                                    dtype=cfg.dtype) / np.sqrt(shape[0])
        else:
            out[name] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return out


def params_from_jax(tree: Dict[str, Any], device=None,
                    cfg: Optional[MLPConfig] = None) -> Dict[str, Any]:
    """The JAX parameter dict (numpy leaves) as tensors on ``device``,
    its shapes checked against ``cfg`` when given."""
    return from_numpy(tree, device, (cfg or MLPConfig()).dtype,
                      param_shapes(cfg) if cfg is not None else None)


class MLP(ParamTree):
    """The MLP's parameters as ``nn.Parameter`` leaves under the JAX
    names; ``params()`` is the dict ``forward`` takes."""

    def __init__(self, cfg: MLPConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, Any]] = None):
        super().__init__(module_params("MLP", cfg, param_shapes(cfg),
                                       init_params, device, generator,
                                       params, cfg.dtype))
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x, self.cfg)


def forward(params: Dict[str, Any], x: torch.Tensor,
            cfg: MLPConfig) -> torch.Tensor:
    """x [B, ...] -> logits [B, n_classes]."""
    n_layers = len(cfg.hidden) + 1
    h = x.reshape(x.shape[0], -1).to(cfg.dtype)
    for i in range(n_layers):
        h = h @ params[f"w{i}"].to(cfg.dtype) + params[f"b{i}"].to(cfg.dtype)
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def loss_fn(params, batch: Dict[str, torch.Tensor],
            cfg: MLPConfig) -> torch.Tensor:
    """Mean cross entropy of {'x': [B, 784], 'y': [B]}."""
    return softmax_xent(forward(params, batch["x"], cfg), batch["y"])


def accuracy(params, batch, cfg: MLPConfig) -> torch.Tensor:
    logits = forward(params, batch["x"], cfg)
    return torch.mean((torch.argmax(logits, -1) == batch["y"]).float())
