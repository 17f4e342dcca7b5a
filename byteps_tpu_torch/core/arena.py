"""Persistent host staging arena for the PS path.

Port of byteps_tpu/core/arena.py: the cpubuff discipline of the reference
(operations.cc:283-414), where host staging buffers are allocated once and
reused every round. Per staging key, an aligned slot is allocated at the
first checkout and handed out again at each later one.

For a card the slots are pinned (page-locked) host memory, from
``torch.empty(..., pin_memory=True)``: a ``non_blocking`` copy between the
card and pageable memory is synchronous, and would stall the thread that
issues it (the backward's, for a streamed gradient). A lease gives the
slot as a numpy array (``buf``, for the client) and as a torch tensor
(``tensor``, for the copies).

Correctness never depends on the arena. A slot is handed out only while
it is free; if it is still leased (``checkout_conflicts``), or the arena
is off (BYTEPS_STAGING_ARENA=0, ``enabled``), the caller gets a fresh
untracked buffer with the same semantics (``fresh_allocs``). A caller that hits an error
mid-round ``abandon()``s its leases: the slot leaves the table and the
next checkout allocates a new one.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

# cache-line alignment for the memcpy-heavy fill and drain paths
SLOT_ALIGN = 64


def usable_staging(out: Optional[np.ndarray], dtype, nbytes: int) -> bool:
    """The acceptance rule for a caller-provided staging buffer: exact
    dtype and byte length, C-contiguous; anything else and the callee
    allocates its own."""
    return (out is not None and out.dtype == dtype
            and out.nbytes == nbytes and out.flags["C_CONTIGUOUS"])


def _aligned_empty(nbytes: int, pin: bool,
                   align: int = SLOT_ALIGN) -> torch.Tensor:
    """Uninitialized uint8 tensor on the host with an align-rounded data
    pointer, page-locked when ``pin``."""
    raw = torch.empty(nbytes + align, dtype=torch.uint8, pin_memory=pin)
    off = (-raw.data_ptr()) % align
    return raw[off:off + nbytes]


class _Slot:
    __slots__ = ("tensor", "buf", "busy", "version")

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.buf = tensor.numpy()
        self.busy = False
        self.version = 0


class ArenaLease:
    """One checkout of one staging buffer: ``buf`` is a C-contiguous uint8
    array of exactly the requested size, ``tensor`` the same bytes as a
    torch tensor. ``fresh`` marks an untracked allocation, whose release
    is a no-op."""

    __slots__ = ("_arena", "key", "buf", "tensor", "fresh", "_version",
                 "_open")

    def __init__(self, arena: Optional["StagingArena"], key: str,
                 slot: _Slot, fresh: bool, version: int = 0):
        self._arena = arena
        self.key = key
        self.buf = slot.buf
        self.tensor = slot.tensor
        self.fresh = fresh
        self._version = version
        self._open = True

    def array(self, dtype) -> np.ndarray:
        """The whole slot as a flat array of ``dtype``."""
        return self.buf.view(dtype)

    def release(self) -> None:
        """Return the slot for reuse, once nothing reads or writes it."""
        if not self._open:
            return
        self._open = False
        if not self.fresh and self._arena is not None:
            self._arena._release(self.key, self._version)

    def abandon(self) -> None:
        """Error-path release: drop the slot instead of recycling it, since
        an in-flight writer may still own the buffer."""
        if not self._open:
            return
        self._open = False
        if not self.fresh and self._arena is not None:
            self._arena._abandon(self.key, self._version)


class StagingArena:
    """Thread-safe key -> persistent staging slot table. ``pin``: slots in
    page-locked memory (a card's copies read and write them).
    ``enabled`` False: every checkout is a fresh buffer."""

    def __init__(self, pin: bool = False, enabled: bool = True) -> None:
        self.pin = pin
        self.enabled = enabled
        self._mu = threading.Lock()
        self._slots: Dict[str, _Slot] = {}  # guarded-by: _mu
        # counters, all guarded-by: _mu
        self._slot_allocs = 0
        self._allocs_avoided = 0
        self._conflicts = 0
        self._fresh = 0
        self._resizes = 0
        self._tag_checkouts: Dict[str, int] = {}

    def checkout(self, key: str, nbytes: int,
                 tag: Optional[str] = None) -> ArenaLease:
        """Lease the slot for ``key`` (allocated at first use), or a fresh
        buffer when the slot is still leased. ``tag`` counts the checkout
        under a pipeline stage in ``stats()`` (``export``: the streamed
        export's slots)."""
        nbytes = int(nbytes)
        with self._mu:
            if tag is not None:
                self._tag_checkouts[tag] = \
                    self._tag_checkouts.get(tag, 0) + 1
            slot = self._slots.get(key) if self.enabled else None
            if not self.enabled or (slot is not None and slot.busy):
                if self.enabled:
                    self._conflicts += 1
                self._fresh += 1
                return ArenaLease(self, key, _Slot(_aligned_empty(
                    nbytes, self.pin)), fresh=True)
            if slot is not None and slot.buf.nbytes != nbytes:
                self._resizes += 1
                slot = None
            if slot is None:
                slot = _Slot(_aligned_empty(nbytes, self.pin))
                self._slots[key] = slot
                self._slot_allocs += 1
            else:
                self._allocs_avoided += 1
            slot.busy = True
            slot.version += 1
            return ArenaLease(self, key, slot, fresh=False,
                              version=slot.version)

    def _release(self, key: str, version: int) -> None:
        with self._mu:
            slot = self._slots.get(key)
            # a stale release after the slot was replaced is ignored
            if slot is not None and slot.version == version:
                slot.busy = False

    def _abandon(self, key: str, version: int) -> None:
        with self._mu:
            slot = self._slots.get(key)
            if slot is not None and slot.version == version:
                del self._slots[key]

    def invalidate_prefix(self, prefix: str) -> None:
        """Drop every free slot whose key starts with ``prefix`` (its
        tensor was re-partitioned)."""
        with self._mu:
            for k in [k for k, s in self._slots.items()
                      if k.startswith(prefix) and not s.busy]:
                del self._slots[k]

    def reset(self) -> None:
        """Drop every slot (shutdown)."""
        with self._mu:
            self._slots.clear()

    def stats(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "slots_live": len(self._slots),
                "bytes_pinned": sum(s.buf.nbytes
                                    for s in self._slots.values()),
                "slot_allocs": self._slot_allocs,
                "allocs_avoided": self._allocs_avoided,
                "checkout_conflicts": self._conflicts,
                "fresh_allocs": self._fresh,
                "resizes": self._resizes,
                "export_checkouts": self._tag_checkouts.get("export", 0),
            }
