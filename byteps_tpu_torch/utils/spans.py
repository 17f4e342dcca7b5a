"""Host-clock spans of a train step's stages.

Off (the default), every mark is a no-op and the step runs as it would
without it. On, each mark first waits for the device, so a span holds the
device and host work of its stage, and the sum of the spans is the step.
The waits serialize what the step would overlap: read the spans as where
the time goes, not as the step time. A step whose stages overlap (the PS
host tier: export under the backward) records intervals it measured
itself with ``add``; those do not sum to the step.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


class StepSpans:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.ms: Dict[str, float] = {}
        self._t = 0.0
        self._device = None

    def start(self, device) -> None:
        self.ms = {}
        if not self.enabled:
            return
        self._device = torch.device(device)
        self._sync()
        self._t = time.perf_counter()

    def _sync(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def add(self, name: str, ms: float) -> None:
        """Add ``ms`` to the span ``name`` (an interval measured by the
        caller)."""
        if self.enabled:
            self.ms[name] = self.ms.get(name, 0.0) + ms

    def mark(self, name: str) -> None:
        """Close the span ``name`` (added to any earlier one of the name)."""
        if not self.enabled:
            return
        self._sync()
        now = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t) * 1e3
        self._t = now
