"""Error feedback and momentum around a codec.

Port of byteps_tpu/ops/compression/feedback.py. The reference stacks
these decorator-style, Momentum around ErrorFeedback around the codec
(compressor.h:28-52):

- ErrorFeedback (error_feedback.cc:22-43):
    corrected = grad + error
    payload   = codec.compress(corrected)
    error'    = corrected - codec.decompress(payload)
  (``Codec.residual``: for dithering one FMA, as XLA contracts it)
- Nesterov momentum (nesterov_momentum.cc:39-50), before compression:
    m'   = mu * m + grad
    out  = grad + mu * m'

XLA contracts both momentum lines and the EF's LR rescale
(grad + error * scale) into FMAs; ``kernels.fma_scalar`` rounds each once
as they do, so the state and the payload are the jitted JAX stack's bit
for bit.

State is a dict of tensors that the caller keeps; ``compress`` returns a
new dict and leaves the old one as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .codecs import Codec
from .kernels import fma_scalar


@dataclasses.dataclass(frozen=True)
class CompressorStack:
    """momentum -> error feedback -> base codec, any stage optional."""

    codec: Codec
    use_ef: bool = False
    momentum_mu: Optional[float] = None   # None = no momentum stage

    def init_state(self, size: int, device=None) -> Dict[str, Any]:
        st: Dict[str, Any] = {}
        if self.use_ef:
            st["error"] = torch.zeros(size, dtype=torch.float32,
                                      device=device)
            # 0 = "no LR seen yet": the first rescale is a no-op
            st["prev_lr"] = torch.zeros((), dtype=torch.float32,
                                        device=device)
        if self.momentum_mu is not None:
            st["momentum"] = torch.zeros(size, dtype=torch.float32,
                                         device=device)
        return st

    def compress(self, grad: torch.Tensor, state: Dict[str, Any],
                 step: int = 0, lr=None) -> Tuple[Dict[str, Any],
                                                  Dict[str, Any]]:
        """(payload, new_state) for flat f32 ``grad``.

        ``lr``: the current learning rate. With EF on, the carried
        residual is rescaled by prev_lr/cur_lr before reuse, so the owed
        parameter delta is conserved across LR changes (the reference's
        vanilla_error_feedback.cc:44-67). None means a constant LR."""
        new_state = dict(state)
        x = grad
        if self.momentum_mu is not None:
            mu = self.momentum_mu
            m = fma_scalar(mu, state["momentum"], x)
            new_state["momentum"] = m
            x = fma_scalar(mu, m, x)
        if self.use_ef:
            error = state["error"]
            if lr is not None:
                prev = state["prev_lr"]
                cur = torch.as_tensor(lr, dtype=torch.float32,
                                      device=prev.device)
                # prev == 0: no LR seen yet; cur == 0 (a schedule touching
                # zero) keeps the residual and the last real LR
                ok = (prev != 0) & (cur != 0)
                safe_cur = torch.where(cur == 0, torch.ones_like(cur), cur)
                scale = torch.where(ok, prev / safe_cur,
                                    torch.ones_like(cur))
                new_state["prev_lr"] = torch.where(cur == 0, prev, cur)
                x = fma_scalar(scale, error, x)
            else:
                x = x + error
            payload = self.codec.compress(x, step)
            new_state["error"] = self.codec.residual(x, payload)
        else:
            payload = self.codec.compress(x, step)
        return payload, new_state

    def decompress(self, payload: Dict[str, Any]) -> torch.Tensor:
        return self.codec.decompress(payload)
