"""On-device compression for the parameter-server path.

Port of byteps_tpu/jax/device_compression.py. The momentum -> error
feedback -> codec stack runs on the card, so only wire-sized payloads
cross to the host, and the server's aggregate comes back wire-sized and
is decompressed on the card. One round of the whole gradient tree:

1. compress every partition of every leaf on the device (the B2, B4 and
   B5 kernels, by codec);
2. pack the payloads into one buffer per dtype and copy each into pinned
   host memory; the round waits on the copy's event before any byte is
   read (the D2H);
3. serialize each partition's wire (the layouts of
   ``ops/compression/host.py``, so the C++ server cannot tell this tier
   from the host tier or from a JAX worker) and submit each leaf through
   the priority scheduler's fused PUSHPULL;
4. parse the replies, copy them into fresh pinned buffers, one per
   dtype, that no arena slot aliases, and upload them (the H2D);
5. decompress on the device, concatenate the partitions and average over
   the workers.

The per-plan round counter is the JAX package's (it seeds randomk and
dithering; the server re-draws randomk's indices from it). Onebit's
payload from B2 is already the wire layout, so the JAX package's
``_portable`` has no counterpart here.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.types import DataType, RequestType, TensorContext, \
    get_command_type
from ..ops.compression import make_compressor
from ..ops.compression.codecs import (
    Codec, DitheringCodec, OnebitCodec, RandomkCodec,
)
from ..ops.compression.feedback import CompressorStack
from ..utils.logging import log
from ..utils.spans import StepSpans

CMD_COMP_F32 = get_command_type(RequestType.COMPRESSED_PUSH_PULL,
                                DataType.FLOAT32)
CMD_F32 = get_command_type(RequestType.DEFAULT_PUSH_PULL, DataType.FLOAT32)

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                 "int8": torch.int8}


def payload_to_wire(codec: Optional[Codec],
                    payload: Dict[str, np.ndarray]) -> np.ndarray:
    """One partition's payload arrays (on the host) -> its wire bytes.
    ``codec=None``: a dense partition (raw f32)."""
    if codec is None:
        return np.ascontiguousarray(payload["raw"]).view(np.uint8)
    if isinstance(codec, OnebitCodec):
        bits = np.ascontiguousarray(payload["bits"]).view(np.uint32)
        scale = np.float32(payload["scale"])
        return np.frombuffer(bits.tobytes() + scale.tobytes(), np.uint8)
    if isinstance(codec, RandomkCodec):
        # indices stay in stream order: the server re-draws the stream
        idx = np.ascontiguousarray(payload["indices"], np.int32)
        val = np.ascontiguousarray(payload["values"], np.float32)
        return np.frombuffer(idx.tobytes() + val.tobytes(), np.uint8)
    if isinstance(codec, DitheringCodec):
        lv = np.ascontiguousarray(payload["levels"], np.int8)
        norm = np.float32(payload["norm"])
        return np.frombuffer(lv.tobytes() + norm.tobytes(), np.uint8)
    raise TypeError(f"no wire serializer for {type(codec).__name__}")


def wire_to_payload(codec: Optional[Codec], n: int,
                    reply: np.ndarray) -> Dict[str, np.ndarray]:
    """One partition's reply bytes -> payload arrays (views)."""
    raw = np.frombuffer(reply, np.uint8)
    if codec is None:
        return {"raw": raw.view(np.float32)}
    if isinstance(codec, OnebitCodec):
        return {"bits": raw[:-4].view(np.int32),
                "scale": raw[-4:].view(np.float32).reshape(())}
    if isinstance(codec, RandomkCodec):
        k = codec.k
        return {"indices": raw[: 4 * k].view(np.int32),
                "values": raw[4 * k:].view(np.float32)}
    if isinstance(codec, DitheringCodec):
        return {"levels": raw[:n].view(np.int8),
                "norm": raw[n: n + 4].view(np.float32).reshape(())}
    raise TypeError(f"no wire parser for {type(codec).__name__}")


def _payload_meta(codec: Optional[Codec], pn: int) -> List[tuple]:
    """(key, dtype name, shape) of a partition's payload, keys sorted as
    a pytree flattens them."""
    if codec is None:
        return [("raw", "float32", (pn,))]
    if isinstance(codec, OnebitCodec):
        return [("bits", "int32", ((pn + 31) // 32,)),
                ("scale", "float32", ())]
    if isinstance(codec, RandomkCodec):
        return [("indices", "int32", (codec.k,)),
                ("values", "float32", (codec.k,))]
    if isinstance(codec, DitheringCodec):
        return [("levels", "int8", (pn,)), ("norm", "float32", ())]
    raise TypeError(f"no payload layout for {type(codec).__name__}")


class _PackSpec:
    """Static packing plan of a round's payloads: one flat buffer per
    dtype, and for each payload array its (dtype, shape, size, offset)
    slot. Payloads are nested [leaf][partition]{key: array}."""

    def __init__(self, plans: List["_LeafPlan"]):
        offsets: Dict[str, int] = {}
        self.layout = []   # [leaf][partition] -> [(key, dt, shape, sz, off)]
        for p in plans:
            leaf = []
            for q, codec in zip(p.ctx.partitions, p.codecs):
                slots = []
                for key, dt, shape in _payload_meta(codec, q.length // 4):
                    size = int(np.prod(shape)) if shape else 1
                    off = offsets.get(dt, 0)
                    offsets[dt] = off + size
                    slots.append((key, dt, shape, size, off))
                leaf.append(slots)
            self.layout.append(leaf)
        self.sizes = offsets

    def pack(self, payloads) -> Dict[str, torch.Tensor]:
        """On the device: payloads -> {dtype: flat buffer}."""
        buckets: Dict[str, list] = {}
        for leaf_slots, leaf_pl in zip(self.layout, payloads):
            for slots, pl in zip(leaf_slots, leaf_pl):
                for key, dt, _, _, _ in slots:
                    buckets.setdefault(dt, []).append(pl[key].reshape(-1))
        return {dt: torch.cat(v) for dt, v in buckets.items()}

    def unpack(self, packed: Dict[str, Any]):
        """{dtype: buffer} -> payloads of views (numpy or torch)."""
        return [[{key: packed[dt][off: off + size].reshape(shape)
                  for key, dt, shape, size, off in slots}
                 for slots in leaf_slots] for leaf_slots in self.layout]

    def pack_host(self, payloads, pin: bool) -> Dict[str, torch.Tensor]:
        """On the host: reply payloads (numpy views) -> {dtype: buffer},
        copied into fresh (pinned, for an upload) buffers, so nothing the
        caller recycles can race the upload."""
        out = {dt: torch.empty(n, dtype=_TORCH_DTYPES[dt], pin_memory=pin)
               for dt, n in self.sizes.items()}
        views = {dt: t.numpy() for dt, t in out.items()}
        for leaf_slots, leaf_pl in zip(self.layout, payloads):
            for slots, pl in zip(leaf_slots, leaf_pl):
                for key, dt, _, size, off in slots:
                    views[dt][off: off + size] = np.ravel(pl[key])
        return out


class _LeafPlan:
    """One tensor's plan: its partitions, a codec stack and EF/momentum
    state per partition on the device, and the host base codecs that give
    the server's kwargs and the reply sizes."""

    def __init__(self, name: str, ctx: TensorContext, kwargs: Dict[str, str],
                 min_compress_bytes: int, device):
        from ..ops.compression.host import make_host_codec

        self.name = name
        self.ctx = ctx
        self.n = (ctx.partitions[-1].offset + ctx.partitions[-1].length) // 4
        if kwargs.get("index_coding", "dense") != "dense":
            log.warning("compression index_coding=%r is a host-tier wire "
                        "option; the device tier ships dense int8 levels",
                        kwargs["index_coding"])
        # EF and momentum run on the worker; the server mirrors only the
        # base codec
        base_kwargs = {k: v for k, v in kwargs.items()
                       if k not in ("ef", "momentum", "momentum_mu",
                                    "index_coding")}
        self.stacks: List[Optional[CompressorStack]] = []
        self.codecs: List[Optional[Codec]] = []
        self.host_base = []
        self.states: List[Dict[str, Any]] = []
        for p in ctx.partitions:
            pn = p.length // 4
            if p.length < max(min_compress_bytes, 8):
                self.stacks.append(None)
                self.codecs.append(None)
                self.host_base.append(None)
                self.states.append({})
            else:
                stack = make_compressor(kwargs, pn)
                self.stacks.append(stack)
                self.codecs.append(stack.codec)
                self.host_base.append(make_host_codec(base_kwargs, pn))
                self.states.append(stack.init_state(pn, device))
        self.step = 0
        self.priority = -ctx.declared_key
        self.installed = False

    def reply_len(self, i: int) -> int:
        hb = self.host_base[i]
        return self.ctx.partitions[i].length if hb is None else \
            hb.wire_bytes()


class DeviceCompressor:
    """Whole-tree compress/decompress on the device around the scheduled
    PS pipeline. One instance per (client, kwargs); it holds the device
    EF/momentum state of every partition across steps."""

    def __init__(self, client, num_workers: int, kwargs: Dict[str, str],
                 min_compress_bytes: int = 0):
        self.client = client
        self.num_workers = num_workers
        self.kwargs = dict(kwargs)
        self.min_compress_bytes = min_compress_bytes
        self._plans: Dict[str, _LeafPlan] = {}
        self._specs: Dict[tuple, _PackSpec] = {}
        self._lock = threading.Lock()

    def plan(self, state, name: str, n_elems: int, device) -> _LeafPlan:
        with self._lock:
            p = self._plans.get(name)
            if p is None or p.n != n_elems:
                ctx = state.registry.init_tensor(name, n_elems * 4,
                                                 DataType.FLOAT32)
                p = _LeafPlan(name, ctx, self.kwargs,
                              self.min_compress_bytes, device)
                self._plans[name] = p
            return p

    def _install(self, plan: _LeafPlan) -> None:
        """Dense init push (allocates the store, the init barrier), then
        the in-band codec kwargs per compressed key."""
        with self._lock:
            if plan.installed:
                return
            self.client.ensure_init(plan.ctx, plan.n * 4)
            for p, hb in zip(plan.ctx.partitions, plan.host_base):
                if hb is not None:
                    self.client.comp_init(p.server, p.key, hb.kwargs_wire())
            plan.installed = True

    def _spec(self, plans: List[_LeafPlan]) -> _PackSpec:
        key = tuple((p.name, p.n) for p in plans)
        spec = self._specs.get(key)
        if spec is None:
            spec = self._specs[key] = _PackSpec(plans)
        return spec

    def push_pull_leaves(self, state, names: List[str],
                         leaves: List[torch.Tensor], average: bool = True,
                         spans=None) -> List[torch.Tensor]:
        """Compress on the device, push_pull the wire bytes through the
        priority pipeline, decompress the aggregate on the device.
        Returns tensors of the leaves' shapes and dtypes. Blocking.
        ``spans``: the step's ``utils.spans.StepSpans`` (default: off)."""
        spans = spans if spans is not None else StepSpans()
        # zero-size leaves carry no data: they pass through unchanged
        live = [i for i, lf in enumerate(leaves) if lf.numel()]
        if len(live) < len(leaves):
            out = list(leaves)
            if live:
                sub = self.push_pull_leaves(
                    state, [names[i] for i in live],
                    [leaves[i] for i in live], average, spans)
                for i, r in zip(live, sub):
                    out[i] = r
            return out
        device = leaves[0].device
        plans = [self.plan(state, nm, lf.numel(), device)
                 for nm, lf in zip(names, leaves)]
        for p in plans:
            self._install(p)
        spec = self._spec(plans)
        # one round number for the whole tree (realigned on the max after
        # a re-plan); it seeds randomk/dithering and matches the server's
        # completed rounds in sync mode
        step0 = max(p.step for p in plans)
        for p in plans:
            p.step = step0 + 1

        payloads = []
        for plan, leaf in zip(plans, leaves):
            flat = leaf.detach().reshape(-1).to(torch.float32)
            pl, new_states = [], []
            for q, stack, st in zip(plan.ctx.partitions, plan.stacks,
                                    plan.states):
                x = flat[q.offset // 4: (q.offset + q.length) // 4]
                if stack is None:
                    pl.append({"raw": x})
                    new_states.append(st)
                else:
                    payload, st2 = stack.compress(x, st, step0)
                    pl.append(payload)
                    new_states.append(st2)
            payloads.append(pl)
            plan.states = new_states
        packed = spec.pack(payloads)
        spans.mark("compress")
        # ONE wire-sized buffer per dtype crosses device -> host, into
        # pinned memory; the event wait is the only sync of the round
        # before the wire
        if device.type == "cuda":
            host = {dt: torch.empty(t.numel(), dtype=t.dtype,
                                    pin_memory=True)
                    for dt, t in packed.items()}
            for dt, t in packed.items():
                host[dt].copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()
        else:
            host = packed
        host_payloads = spec.unpack({dt: t.numpy() for dt, t in host.items()})
        spans.mark("d2h")

        arena = state.arena
        leases: List = []
        handles = []
        try:
            for plan, pl in zip(plans, host_payloads):
                wires = [payload_to_wire(c, p)
                         for p, c in zip(pl, plan.codecs)]
                reply_lens = [plan.reply_len(i) for i in range(len(wires))]
                reply_bufs = None
                if arena is not None:
                    ls = [arena.checkout(f"{plan.name}:reply:{i}", rl)
                          for i, rl in enumerate(reply_lens)]
                    leases.extend(ls)
                    reply_bufs = [lease.buf for lease in ls]
                handle = state.handles.allocate(plan.name)
                state.scheduler.submit_wire(
                    plan.ctx, wires, reply_lens,
                    [CMD_F32 if c is None else CMD_COMP_F32
                     for c in plan.codecs],
                    handle, version=state.next_version(plan.name),
                    priority=plan.priority, reply_bufs=reply_bufs)
                handles.append(handle)
            replies = []
            for plan, h in zip(plans, handles):
                reps = state.handles.wait_and_clear(h.id)
                replies.append([
                    wire_to_payload(c, q.length // 4, rep)
                    for rep, c, q in zip(reps, plan.codecs,
                                         plan.ctx.partitions)])
            spans.mark("wire")
            # copies out of the arena's reply slots: they are idle after
            up = spec.pack_host(replies, pin=device.type == "cuda")
        except BaseException:
            for lease in leases:
                lease.abandon()
            raise
        for lease in leases:
            lease.release()
        dev = {dt: t.to(device, non_blocking=True) for dt, t in up.items()}
        spans.mark("h2d")

        out = []
        for plan, leaf, reps in zip(plans, leaves, spec.unpack(dev)):
            chunks = [rep["raw"] if c is None else c.decompress(rep)
                      for rep, c in zip(reps, plan.codecs)]
            flat = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
            if average and self.num_workers > 1:
                flat = flat / self.num_workers
            out.append(flat.reshape(leaf.shape).to(leaf.dtype))
        spans.mark("decompress")
        return out
