"""Compressed push_pull over the parameter server, with host codecs.

Port of byteps_tpu/server/compressed.py: the worker side of the
reference's COMPRESS -> PUSH -> server decompress/sum/recompress -> PULL
-> DECOMPRESS dataflow (core_loops.cc:498-648, server.cc:92-118), with
the numpy codecs of ``ops/compression/host.py`` (onebit, topk, randomk,
dithering; the server mirrors each, ``native/ps.cc`` CompressorCfg):

- a tensor is partitioned as the dense path partitions it, and every
  partition has its own codec stack (operations.cc:283-414); partitions
  under ``min_compress_bytes`` travel dense (operations.cc:361-364);
- a stack (momentum -> error feedback -> codec) runs on the worker and
  keeps its state across rounds; the server mirrors the base codec,
  whose kwargs go in-band per key (``PSClient.comp_init``);
- the per-tensor round counter seeds randomk and dithering and matches
  the server's completed rounds.

The partitions go through the scheduler's COMPRESS and DECOMPRESS stages
(``PipelineScheduler.submit(comp=...)``), fused or two-op; a retry sends
the compressed bytes again, and after a failover the scheduler installs
the codec's kwargs on the adoptive server. The JAX package's blocking
round trip without the scheduler (``CompressedRegistry.push_pull``) is
not ported.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..core.types import DataType, TensorContext
from ..ops.compression.host import make_host_codec


def compress_partition(stack, in_view_u8: np.ndarray,
                       step: int) -> np.ndarray:
    """One partition's wire payload: its f32 input through the stack."""
    return np.frombuffer(stack.compress(in_view_u8.view(np.float32), step),
                         np.uint8)


def decompress_partition(stack, reply_u8: np.ndarray,
                         out_view_u8: np.ndarray) -> None:
    """One partition's reply decoded into its f32 output slot."""
    out_view_u8[:] = stack.decompress(reply_u8).view(np.uint8)


class CompressedTensor:
    """The codec stacks and the round counter of one named f32 tensor."""

    def __init__(self, client, ctx: TensorContext, kwargs: Dict[str, str],
                 min_compress_bytes: int = 0):
        if ctx.dtype != DataType.FLOAT32:
            raise ValueError("compressed push_pull requires f32 gradients "
                             "(the codecs are f32 transforms)")
        self.client = client
        self.ctx = ctx
        self.step = 0
        # pinned at the first submission: rounds of a stateful codec must
        # not be reordered in the admission heap
        self.priority: Optional[int] = None
        self._lock = threading.Lock()
        self.stacks = [None if p.length < max(min_compress_bytes, 8)
                       else make_host_codec(kwargs, p.length // 4)
                       for p in ctx.partitions]
        self._installed = False

    @property
    def nbytes(self) -> int:
        last = self.ctx.partitions[-1]
        return last.offset + last.length

    def begin_round(self) -> int:
        """The next round number (it seeds the codecs), after the dense
        init push of every partition and the in-band codec install of the
        compressed ones on first use."""
        with self._lock:
            if not self._installed:
                self.client.ensure_init(self.ctx, self.nbytes)
                for p, stack in zip(self.ctx.partitions, self.stacks):
                    if stack is not None:
                        self.client.comp_init(p.server, p.key,
                                              stack.kwargs_wire())
                self._installed = True
            step = self.step
            self.step += 1
            return step


class CompressedRegistry:
    """name -> CompressedTensor for a training loop: one per named
    gradient, holding its codec state across steps."""

    def __init__(self, client, num_workers: int, kwargs: Dict[str, str],
                 min_compress_bytes: int = 0):
        self.client = client
        self.num_workers = num_workers
        self.kwargs = dict(kwargs)
        self.min_compress_bytes = min_compress_bytes
        self._tensors: Dict[str, CompressedTensor] = {}
        self._lock = threading.Lock()

    def get(self, state, name: str, flat: np.ndarray) -> CompressedTensor:
        """The tensor's codecs, made anew when its size changed."""
        from .client import get_or_init_ctx
        with self._lock:
            ct = self._tensors.get(name)
            if ct is None or ct.nbytes != flat.nbytes:
                ctx = get_or_init_ctx(state, name, flat)
                ct = CompressedTensor(self.client, ctx, self.kwargs,
                                      self.min_compress_bytes)
                self._tensors[name] = ct
            return ct

    def tiers(self) -> Dict[str, str]:
        """name -> codec of each tensor with a compressed partition (the
        health plane's lossy leaves)."""
        codec = self.kwargs.get("compressor", "")
        with self._lock:
            return {n: codec for n, ct in self._tensors.items()
                    if any(s is not None for s in ct.stacks)}

    def push_pull_async(self, state, name: str, flat: np.ndarray,
                        average: bool = True,
                        priority: Optional[int] = None,
                        out: Optional[np.ndarray] = None) -> int:
        """Submit one compressed round through the scheduler's COMPRESS ->
        WIRE -> DECOMPRESS stages; returns the handle id. ``out``: the
        flat f32 result buffer (see ``PipelineScheduler.submit``)."""
        flat = np.ascontiguousarray(flat, np.float32)
        ct = self.get(state, name, flat)
        if ct.priority is None:
            ct.priority = (priority if priority is not None
                           else -ct.ctx.declared_key)
        handle = state.handles.allocate(name)
        state.scheduler.submit(
            ct.ctx, flat, handle, average, self.num_workers,
            version=state.next_version(name), priority=ct.priority,
            comp=ct, out=out)
        return handle.id
