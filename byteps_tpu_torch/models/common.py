"""What the ported models share: parameter trees as ``nn.Module``s, the
JAX package's trees carried across, and the classifiers' cross entropy.

The JAX models keep their parameters in nested dicts whose leaf names
and shapes are the PS keys (``training.train.named_leaves``); the port
keeps the same dicts. ``ParamTree`` registers each dict as a submodule
and each leaf as an ``nn.Parameter`` (and, for ResNet's batch-norm
state, as a buffer), so ``named_parameters()`` walks the JAX paths with
"." for "/" and ``params()`` hands the nested dict to the functional
``forward`` and ``loss_fn`` of each model.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.state import resolve_device
from ..parallel.sharding import place_params


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def check_shapes(tree, shapes, path: str = "") -> None:
    """Raise unless ``tree`` has exactly the keys of ``shapes`` and each
    leaf its shape."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or '/'}: keys {got} != "
                             f"{sorted(shapes)}")
        for k in shapes:
            check_shapes(tree[k], shapes[k], f"{path}/{k}")
        return
    if tuple(tree.shape) != tuple(shapes):
        raise ValueError(f"{path}: shape {tuple(tree.shape)} != "
                         f"{tuple(shapes)}")


def from_numpy(tree, device=None, dtype: torch.dtype = torch.float32,
               shapes=None, mesh=None, specs=None):
    """A JAX parameter tree, as nested dicts of arrays, to tensors of
    ``dtype`` on ``device``; checked against ``shapes`` when given. With
    ``mesh``, this rank's slice of every leaf by the spec tree ``specs``
    (``parallel.sharding.place_params``, the counterpart of
    ``jax.device_put`` with a ``NamedSharding``)."""
    device = resolve_device(device)
    out = tree_map(lambda x: torch.tensor(np.asarray(x), dtype=dtype), tree)
    if shapes is not None:
        check_shapes(out, shapes)
    if mesh is not None:
        out = place_params(out, mesh, specs)
    return tree_map(lambda x: x.to(device), out)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dicts become submodules,
    ``params`` leaves ``nn.Parameter``s, ``buffers`` leaves buffers (a
    dict may hold both, as a ResNet block's ``bn1`` holds its scale and
    bias and its running mean and variance)."""

    def __init__(self, params: Dict[str, Any],
                 buffers: Optional[Dict[str, Any]] = None):
        super().__init__()
        buffers = buffers or {}
        for k in sorted(set(params) | set(buffers)):
            p, b = params.get(k), buffers.get(k)
            if isinstance(p, dict) or isinstance(b, dict):
                self.add_module(k, ParamTree(p or {}, b or {}))
            elif p is not None:
                self.register_parameter(k, nn.Parameter(p))
            else:
                self.register_buffer(k, b)

    def _tree(self, kind: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in getattr(self, f"_{kind}").items():
            out[k] = v
        for k, m in self._modules.items():
            sub = m._tree(kind)
            if sub:
                out[k] = sub
        return out

    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX model's nested dict."""
        return self._tree("parameters")

    def buffer_tree(self) -> Dict[str, Any]:
        return self._tree("buffers")


def module_params(name: str, cfg, shapes, init, device, generator, params,
                  dtype: torch.dtype = torch.float32):
    """A model constructor's parameters: ``params`` (checked against
    ``shapes``) or, without them, ``init(cfg, generator, device)``; as
    ``dtype`` tensors on ``device``."""
    device = resolve_device(device)
    if params is None:
        if generator is None:
            raise ValueError(f"{name} needs a seeded torch.Generator or "
                             f"explicit params")
        params = init(cfg, generator, device)
    check_shapes(params, shapes)
    return tree_map(lambda x: x.detach().to(device=device, dtype=dtype),
                    params)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(log_softmax(logits)[label]) of [B, n] logits, the JAX
    classifiers' loss."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def param_count(params) -> int:
    n = 0

    def add(x):
        nonlocal n
        n += int(np.prod(x.shape))
    tree_map(add, params)
    return n
