"""On-device compression for the parameter-server path.

Port of byteps_tpu/jax/device_compression.py. The momentum -> error
feedback -> codec stack runs on the card, so only wire-sized payloads
cross to the host, and the server's aggregate comes back wire-sized and
is decompressed on the card. One round of the whole gradient tree:

1. compress on the device: the dithering or randomk partitions of every
   leaf as one round (``_Round``: one error-feedback buffer, one norm
   reduction, one B4 or B5 launch that writes straight into the packed
   buffer, one residual pass), onebit (B2) and topk partition by
   partition (topk has no round kernel, as in the JAX package);
2. pack the payloads into one buffer per dtype and copy each into pinned
   host memory; the round waits on the copy's event before any byte is
   read (the D2H);
3. serialize each partition's wire (the layouts of
   ``ops/compression/host.py``, so the C++ server cannot tell this tier
   from the host tier or from a JAX worker) and submit each leaf through
   the priority scheduler's fused PUSHPULL;
4. parse the replies, copy them into fresh pinned buffers, one per
   dtype, that no arena slot aliases, and upload them (the H2D);
5. decompress on the device (a round's partitions in one pass over the
   round), concatenate the partitions and average over the workers.

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
    Codec, DitheringCodec, OnebitCodec, RandomkCodec, TopkCodec,
)
from ..ops.compression import kernels as K
from ..ops.compression import rng
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
    if isinstance(codec, (TopkCodec, RandomkCodec)):
        idx = np.ascontiguousarray(payload["indices"], np.int32)
        val = np.ascontiguousarray(payload["values"], np.float32)
        if isinstance(codec, TopkCodec):
            # the host wire's topk indices ascend (``HostTopk.select``);
            # the codec's follow |x| descending. Randomk's stay in stream
            # order: the server re-draws the stream
            order = np.argsort(idx, kind="stable")
            idx, val = idx[order], val[order]
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
    if isinstance(codec, (TopkCodec, RandomkCodec)):
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
    if isinstance(codec, (TopkCodec, RandomkCodec)):
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
        self.round: Optional[_Round] = None   # set by DeviceCompressor

    def pack(self, payloads, written=None) -> Dict[str, torch.Tensor]:
        """On the device: payloads -> {dtype: flat buffer}. ``written``:
        buffers that a round kernel already filled, slot by slot."""
        written = written or {}
        buckets: Dict[str, list] = {}
        for leaf_slots, leaf_pl in zip(self.layout, payloads):
            for slots, pl in zip(leaf_slots, leaf_pl):
                for key, dt, _, _, _ in slots:
                    if dt not in written:
                        buckets.setdefault(dt, []).append(
                            pl[key].reshape(-1))
        out = dict(written)
        out.update({dt: torch.cat(v) for dt, v in buckets.items()})
        return out

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


class _Round:
    """The dithering or randomk partitions of one round (every leaf of a
    ``push_pull_leaves`` call), compressed and decompressed as a whole.
    Their slices form the round's flat ``x``, in [leaf][partition] order;
    it has one error-feedback buffer, one norm reduction, one B4 or B5
    launch over a descriptor table, and one residual pass (for dithering
    one launch of ``dithering_dequantize_round`` over the same table,
    which also dequantizes the aggregate). Every level, index, norm and
    wire byte is the partition-by-partition codec's.

    All compressed partitions of a call share one kwargs, so one codec's
    settings (its size and k aside), and their levels (int8) or indices
    (int32) fill that dtype's whole packed buffer in round order. Built
    once per pack spec, with its tables."""

    def __init__(self, plans: List["_LeafPlan"], spec: "_PackSpec",
                 members: list):
        self.members = members      # (leaf, partition, flat offset, n, stack)
        self.codec = members[0][4].codec
        self.use_ef = members[0][4].use_ef
        self.dithering = isinstance(self.codec, DitheringCodec)
        ns = np.array([m[3] for m in members], np.int64)
        x_offs = np.concatenate([[0], np.cumsum(ns)[:-1]]).astype(np.int64)
        self.spans = list(zip(x_offs.tolist(), ns.tolist()))
        self.total = int(ns.sum())
        self.at = {(i, j): span for (i, j, *_), span in
                   zip(members, self.spans)}
        # leaves whose every partition is in the round: one view of it
        self.whole = {}
        for i, p in enumerate(plans):
            spans = [self.at.get((i, j)) for j in range(len(p.codecs))]
            if None not in spans:
                self.whole[i] = (spans[0][0], spans[-1][0] + spans[-1][1])
        slots = [{key: off for key, _, _, _, off in spec.layout[i][j]}
                 for i, j, *_ in members]
        if self.dithering:
            if [sl["levels"] for sl in slots] != x_offs.tolist() or \
                    spec.sizes["int8"] != self.total:
                raise ValueError("a dithering round must fill the int8 "
                                 "buffer in round order")
            self.table = K.dithering_table(x_offs, ns, x_offs)
            self._host = {"f32_slots": np.array([sl["norm"] for sl in slots],
                                                np.int64)}
        else:
            ks = np.array([m[4].codec.k for m in members], np.int64)
            k_offs = np.concatenate([[0], np.cumsum(ks)[:-1]])
            if [sl["indices"] for sl in slots] != k_offs.tolist() or \
                    spec.sizes["int32"] != int(ks.sum()):
                raise ValueError("a randomk round must fill the int32 "
                                 "buffer in round order")
            self.table = K.randomk_table(ns, ks, k_offs)
            self.k_spans = list(zip(k_offs.tolist(), ks.tolist()))
            # each value's slot in the f32 buffer, each index's partition
            f32_slots = np.concatenate([sl["values"] + np.arange(k)
                                        for sl, k in zip(slots, ks)])
            self._host = {"f32_slots": f32_slots,
                          "starts": np.repeat(x_offs, ks)}
        self._dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self.error: Optional[torch.Tensor] = None
        self.error_views: List[torch.Tensor] = []

    @staticmethod
    def build(plans: List["_LeafPlan"],
              spec: "_PackSpec") -> Optional["_Round"]:
        members = [(i, j, q.offset // 4, q.length // 4, stack)
                   for i, p in enumerate(plans)
                   for j, (q, stack) in enumerate(zip(p.ctx.partitions,
                                                      p.stacks))
                   if stack is not None and isinstance(
                       stack.codec, (DitheringCodec, RandomkCodec))]
        return _Round(plans, spec, members) if members else None

    def _on(self, device) -> Dict[str, torch.Tensor]:
        """The round's index tensors on ``device``, uploaded once."""
        d = self._dev.get(device)
        if d is None:
            d = self._dev[device] = {k: torch.from_numpy(v).to(device)
                                     for k, v in self._host.items()}
        return d

    def _error_buffer(self, plans, device) -> torch.Tensor:
        """The round's error buffer. Every member's ``state["error"]`` is
        a view into it; a residual that another round's buffer (or the
        plan's own) holds is copied in first."""
        if self.error is None:
            self.error = torch.zeros(self.total, dtype=torch.float32,
                                     device=device)
            self.error_views = [self.error[a: a + n] for a, n in self.spans]
        for (i, j, *_), view in zip(self.members, self.error_views):
            st = plans[i].states[j]
            if st["error"] is not view:
                view.copy_(st["error"])
                st["error"] = view
        return self.error

    def compress(self, plans, flats: List[torch.Tensor], step: int,
                 payloads: list) -> Dict[str, torch.Tensor]:
        """Momentum (per partition) -> error feedback -> codec over the
        round. Fills the members' payload dicts in ``payloads``
        [leaf][partition] and returns the packed buffer that the round
        kernel wrote, {dtype: buffer}."""
        device = flats[0].device
        x = torch.cat([flats[i][off: off + n]
                       for i, _, off, n, _ in self.members])
        mu = self.members[0][4].momentum_mu
        if mu is not None:
            # the momentum of the whole round: m' = fma(mu, m, x), then
            # x = fma(mu, m', x), as XLA contracts the stack's two lines;
            # each member's state becomes its view of the new buffer
            states = [plans[i].states[j] for i, j, *_ in self.members]
            m = K.fma_scalar(mu, torch.cat([st["momentum"] for st in states]),
                             x)
            x = K.fma_scalar(mu, m, x, out=x)
            for st, (a, n) in zip(states, self.spans):
                st["momentum"] = m[a: a + n]
        if self.use_ef:
            # grad + error, in place (f32 addition commutes bit for bit)
            x = self._error_buffer(plans, device).add_(x)
        base = rng.uniform_base(self.codec.seed, step)
        c = self.codec
        if self.dithering:
            norms = self.norms(self.error_views if self.use_ef else
                               [x[a: a + n] for a, n in self.spans])
            levels = torch.empty(self.total, dtype=torch.int8, device=device)
            K.dithering_levels_round(x, norms, self.table, base, c.s,
                                     c.partition, levels)
            for m, ((i, j, *_), (a, n)) in enumerate(zip(self.members,
                                                         self.spans)):
                payloads[i][j] = {"levels": levels[a: a + n],
                                  "norm": norms[m]}
            if self.use_ef:
                # x - dec * norm in place, one rounding (the JAX residual)
                K.dithering_dequantize_round(levels, norms, self.table, c.s,
                                             c.partition, x, residual=True)
            return {"int8": levels}
        idx = torch.empty(self.table.out_extent, dtype=torch.int32,
                          device=device)
        K.randomk_indices_round(self.table, base, idx)
        at = idx.long().add_(self._on(device)["starts"])
        values = x[at]
        for (i, j, *_), (a, k) in zip(self.members, self.k_spans):
            payloads[i][j] = {"indices": idx[a: a + k],
                              "values": values[a: a + k]}
        if self.use_ef:
            # x - scatter(values): a drawn x[i] - x[i] is +0
            x.index_fill_(0, at, 0.0)
        return {"int32": idx}

    def norms(self, views: List[torch.Tensor]) -> torch.Tensor:
        """f32 [members]: ``DitheringCodec.norm`` of each member's slice.
        The max norm is one reduction over the round (a max is exact in
        any order, so the bits are codec.norm's); L2 stays partition by
        partition, keeping its summation order."""
        if self.codec.normalize == "max":
            norms = torch.stack(torch._foreach_norm(views, float("inf")))
            return norms.clamp_min_(1e-30)
        return torch.stack([self.codec.norm(v) for v in views])

    def decompress(self, dev: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The round's part of the uploaded aggregate, f32 [total] in
        round order."""
        f32 = dev["float32"]
        d = self._on(f32.device)
        if self.dithering:
            c = self.codec
            out = torch.empty(self.total, dtype=torch.float32,
                              device=f32.device)
            return K.dithering_dequantize_round(
                dev["int8"], f32[d["f32_slots"]], self.table, c.s,
                c.partition, out)
        out = torch.zeros(self.total, dtype=torch.float32, device=f32.device)
        # index_put_ without accumulate: a repeated index keeps one of
        # its (equal) values, like RandomkCodec.decompress
        out.index_put_((dev["int32"].long().add_(d["starts"]),),
                       f32[d["f32_slots"]])
        return out


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
        """The pack spec of these leaves, and beside it (``spec.round``)
        their dithering or randomk round, or None."""
        key = tuple((p.name, p.n) for p in plans)
        spec = self._specs.get(key)
        if spec is None:
            spec = self._specs[key] = _PackSpec(plans)
            spec.round = _Round.build(plans, spec)
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

        flats = [leaf.detach().reshape(-1).to(torch.float32)
                 for leaf in leaves]
        payloads = [[None] * len(p.codecs) for p in plans]
        written = {} if spec.round is None else \
            spec.round.compress(plans, flats, step0, payloads)
        # the rest partition by partition: dense, onebit (B2) and topk
        for plan, flat, pl in zip(plans, flats, payloads):
            for j, (q, stack) in enumerate(zip(plan.ctx.partitions,
                                               plan.stacks)):
                if pl[j] is not None:
                    continue
                x = flat[q.offset // 4: (q.offset + q.length) // 4]
                if stack is None:
                    pl[j] = {"raw": x}
                else:
                    pl[j], plan.states[j] = stack.compress(
                        x, plan.states[j], step0)
        packed = spec.pack(payloads, written)
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

        rnd = spec.round
        agg = None if rnd is None else rnd.decompress(dev)
        out = []
        for i, (plan, leaf, reps) in enumerate(zip(plans, leaves,
                                                   spec.unpack(dev))):
            if rnd is not None and i in rnd.whole:
                a, b = rnd.whole[i]
                flat = agg[a: b]
            else:
                chunks = []
                for j, (rep, c) in enumerate(zip(reps, plan.codecs)):
                    if c is None:
                        chunks.append(rep["raw"])
                    elif rnd is not None and (i, j) in rnd.at:
                        a, n = rnd.at[(i, j)]
                        chunks.append(agg[a: a + n])
                    else:
                        chunks.append(c.decompress(rep))
                flat = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
            if average and self.num_workers > 1:
                flat = flat / self.num_workers
            out.append(flat.reshape(leaf.shape).to(leaf.dtype))
        spans.mark("decompress")
        return out
