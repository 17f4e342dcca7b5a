"""Train-step construction.

Port of byteps_tpu/jax/train.py: ``make_train_step`` (:37-85) and
``make_ps_train_step`` (:562-1920), its device-compressed tier (:875-895)
and its host tier (:928-1874). The JAX steps are compiled programs over
the mesh; here they are eager: forward and backward on the local batch,
the gradient round, then the optimizer. The returned loss is the mean
over the ``dp`` group, like the JAX step's ``pmean``.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.spans import StepSpans
from .optim import make_leaf_apply


def make_train_step(loss_fn: Callable, optimizer):
    """``loss_fn(batch) -> scalar`` on the local batch (a closure over the
    model's parameters); ``optimizer`` a ``DistributedOptimizer``.
    Returns ``step(batch) -> loss`` (a detached scalar tensor)."""

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        optimizer.step()
        loss = loss.detach().clone()
        group = getattr(optimizer, "group", None)
        if group is not None and dist.get_world_size(group) > 1:
            dist.all_reduce(loss, group=group)
            loss /= dist.get_world_size(group)
        return loss

    return step


def named_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) pairs of a nested dict of tensors (or an
    ``nn.Module``'s parameters, nested at each "."), in the order a JAX
    pytree of the same dicts flattens: keys sorted at every level, the
    path joined by "/"."""
    if isinstance(params, torch.nn.Module):
        tree: Dict[str, Any] = {}
        for name, p in params.named_parameters():
            *parents, last = name.split(".")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = p
        params = tree
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            out.append((prefix[:-1], node))

    walk(params, "")
    return out


def make_ps_train_step(loss_fn: Callable, optimizer, params,
                       compression: Optional[Dict[str, str]] = None,
                       min_compress_bytes: Optional[int] = None,
                       device_compress: bool = True,
                       stream_export: Optional[bool] = None,
                       sharded_apply: Optional[bool] = None,
                       rowsparse_params=None,
                       local_shard_export: Optional[bool] = None):
    """The parameter-server train step (byteps_tpu/jax/train.py:562).

    ``loss_fn(batch) -> scalar`` closes over the model; ``optimizer`` is a
    plain ``torch.optim`` optimizer; ``params`` is the model's nested
    parameter dict (``Llama.params()``) or the ``nn.Module``, and names
    the gradients ("grad/" + path, as the JAX step names them), which
    are the PS keys. Without a PS client (no servers configured) either
    tier reduces the gradients and the loss over ``dp`` (the mean) and
    runs ``optimizer.step()``.

    ``compression`` (codec kwargs, e.g. ``{"compressor": "dithering",
    "ef": "vanilla"}``) with ``device_compress`` (the default) takes the
    device tier: one round over every gradient, compressed and
    decompressed on the card (``device_compression.DeviceCompressor``),
    then ``optimizer.step()``. ``step.spans`` records forward_backward,
    compress, d2h, wire, h2d, decompress, optimizer;
    ``step.device_compressor()`` is the round's compressor.

    ``compression=None`` (BytePS's default, dense) or
    ``device_compress=False`` (the host codecs of
    ``server/compressed.py``) takes the host tier (``HostTierStep``):
    gradients leave the card as the backward produces them (streamed
    export, ``stream_export``, default BYTEPS_STREAM_EXPORT), small ones
    in one fused bucket (BYTEPS_FUSION_BYTES), each key through the
    priority scheduler's fused PUSHPULL, and each leaf's optimizer step
    the moment its aggregate lands (``sharded_apply``, default
    BYTEPS_SHARDED_APPLY; SGD, Adam and AdamW, ``training/optim.py``).
    ``step.spans`` records forward_backward, export, wire, h2d, apply;
    ``step.counters`` the streamed export's overlap.

    ``min_compress_bytes`` (default BYTEPS_MIN_COMPRESS_BYTES): partitions
    (device tier) or tensors (host tier) under it travel dense.

    ``rowsparse_params`` and ``local_shard_export`` are the JAX step's and
    not yet ported: asked for, they raise.

    Returns ``step(batch) -> loss`` (a detached scalar, the dp mean).
    ``step.close()`` removes what the step holds on the parameters (the
    host tier's backward hooks) and stops its threads; call it when
    done with the step."""
    if rowsparse_params:
        raise NotImplementedError("rowsparse_params (the row-sparse wire) "
                                  "is not yet ported to byteps_tpu_torch")
    if local_shard_export:
        raise NotImplementedError(
            "local_shard_export is not yet ported to byteps_tpu_torch (it "
            "needs a dp group of more than one, which PS mode refuses)")
    named = named_leaves(params)
    names = ["grad/" + n for n, _ in named]
    tensors = [t for _, t in named]
    if compression is None or not device_compress:
        return HostTierStep(loss_fn, optimizer, names, tensors, compression,
                            min_compress_bytes, stream_export,
                            sharded_apply)
    return _device_tier_step(loss_fn, optimizer, names, tensors,
                             compression, min_compress_bytes)


def _dp_mean_grads(loss_fn, batch, tensors, group):
    """Forward and backward on the local batch, then the mean of the
    gradients and of the loss over the ``dp`` group (nothing to do for a
    group of one). Returns (loss, grads)."""
    from ..ops.push_pull import psum_tree
    loss = loss_fn(batch)
    loss.backward()
    loss = loss.detach().clone()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in tensors]
    n = dist.get_world_size(group)
    if n > 1:
        grads = psum_tree(grads, group, average=True)
        dist.all_reduce(loss, group=group)
        loss /= n
    return loss, grads


def _device_tier_step(loss_fn, optimizer, names, tensors, compression,
                      min_compress_bytes):
    """The device-compressed tier (byteps_tpu/jax/train.py:875-895):

    1. forward and backward on the local batch;
    2. the ``dp`` reduce (mean; nothing to do for a group of one);
    3. one device-compressed PS round over the named gradients: compress
       on the card, fused PUSHPULL through the scheduler to the C++
       server, decompress the aggregate on the card;
    4. ``optimizer.step()`` on the averaged gradients."""
    from ..core.state import get_state
    from .device_compression import DeviceCompressor

    comp_state: Dict[str, Any] = {"client": None, "device": None}
    spans = StepSpans()

    def step(batch):
        state = get_state().require()
        spans.start(state.device)
        optimizer.zero_grad(set_to_none=True)
        loss, grads = _dp_mean_grads(loss_fn, batch, tensors, state.group)
        spans.mark("forward_backward")
        if state.ps_client is not None:
            client = state.ps_client
            if comp_state["client"] is not client:
                mcb = min_compress_bytes
                if mcb is None:
                    mcb = state.config.min_compress_bytes
                comp_state["device"] = DeviceCompressor(
                    client, state.config.num_workers, compression, mcb)
                comp_state["client"] = client
            grads = comp_state["device"].push_pull_leaves(
                state, names, grads, spans=spans)
        for t, g in zip(tensors, grads):
            t.grad = g
        optimizer.step()
        spans.mark("optimizer")
        return loss

    step.spans = spans
    step.device_compressor = lambda: comp_state["device"]
    step.close = lambda: None       # it holds nothing on the parameters
    return step


# --------------------------------------------------------------------- #
# the host tier: streamed export, bucket fusion, completion-ordered drain
# --------------------------------------------------------------------- #

def fused_key(members: List[Tuple[str, int]]) -> str:
    """The PS name of a bucket of small leaves, from its (name, elements)
    members in order: the JAX package's, letter for letter, so workers of
    both packages declare one key (byteps_tpu/jax/train.py:1145-1150)."""
    digest = hashlib.sha1(";".join(f"{n}:{size}" for n, size in members)
                          .encode()).hexdigest()[:12]
    return f"fused/{digest}"


class _Export:
    """One step's export: the leaves the backward's hooks handed to the
    export worker, the submissions, the arena leases and the clocks of
    the step's counters and spans."""

    def __init__(self, state):
        self.state = state
        # streamed leaf -> (the worker's future of its handle, its slot)
        self.futures: Dict[int, tuple] = {}
        self.leases: List = []
        self.handles: List = []
        self.t_backward_end = 0.0
        self._mu = threading.Lock()
        self.first_export: Optional[float] = None    # guarded-by: _mu
        self.first_push: Optional[float] = None      # guarded-by: _mu
        self.last_submit: Optional[float] = None     # guarded-by: _mu
        self.submitted_bytes = 0                     # guarded-by: _mu

    def began(self) -> None:
        with self._mu:
            if self.first_export is None:
                self.first_export = time.perf_counter()

    def pushed(self, nbytes: int) -> None:
        now = time.perf_counter()
        with self._mu:
            if self.first_push is None:
                self.first_push = now
            self.last_submit = now
            self.submitted_bytes += nbytes

    def checkout(self, key: str, nbytes: int, tag=None):
        lease = self.state.arena.checkout(key, nbytes, tag=tag)
        with self._mu:
            self.leases.append(lease)
        return lease


class HostTierStep:
    """The host tier of the PS train step (byteps_tpu/jax/train.py
    :928-1874), as the callable ``make_ps_train_step`` returns:

    - streamed export (:707-785, ``_StreamRound`` :270): a
      ``register_post_accumulate_grad_hook`` on every parameter of at
      least ``fusion_bytes`` makes a side stream wait on the backward's
      stream, copies the gradient into the leaf's pinned arena slot
      there (``non_blocking``; ``record_stream`` keeps the caching
      allocator off the gradient until then), records an event and
      enqueues the leaf to one export worker thread, nothing more: the
      worker waits for the copy, makes the key's first install and
      submits at the measured production order's priority
      (``scheduler.production_priority``); nothing that waits runs on
      the backward's thread (the lesson of :200-232);
    - post-backward export (every leaf with ``stream_export`` off): the
      rest, copied after the backward, leaves under ``fusion_bytes``
      concatenated into one bucket key (:1127-1170) by their copies;
    - the fused PUSHPULL of each key through the priority scheduler,
      dense or through the host codecs, the aggregate written back into
      the slot it was pushed from;
    - the completion-ordered drain (``land`` :1605, ``_dispatch`` :1676):
      the handles' done-callbacks put the key's index on a queue; the
      step's thread takes them in completion order, copies each
      aggregate into ``param.grad`` on a copy stream, makes the compute
      stream wait, and runs that leaf's optimizer step
      (``optim.LeafApply``), or one ``optimizer.step()`` after the drain
      for another optimizer;
    - the slots are released at the next step's start, once those copies
      have completed (:800-815).

    A hook that fails raises out of the backward: there is no quiet
    switch to another path (the JAX package's ``_disable_stream``). The
    hooks hold the step weakly; ``close()`` removes them and stops the
    export worker.
    Not ported (each raises where asked for): rowsparse, the
    locality-shard export (it needs a ``dp`` group above one, which PS
    mode refuses), cross-barrier staleness, the ledger and health planes.

    ``spans`` (off by default): forward_backward (step start to the
    backward's end on the device), export (the first leaf handed over to
    the last submission), wire (the backward's end to the last
    completion), h2d and apply (each copy and step waited for). They
    overlap and do not sum to the step. ``counters``, set every step:
    ``ttfp_ms`` (the backward's start to the first submission),
    ``bytes_before_backward_end`` (bytes submitted before the backward's
    last kernel ended), ``leaves_streamed``, ``leaves_post_backward``,
    ``fused_buckets``, ``bytes_pushed``."""

    def __init__(self, loss_fn, optimizer, names: List[str],
                 tensors: List[torch.Tensor],
                 compression: Optional[Dict[str, str]],
                 min_compress_bytes: Optional[int],
                 stream_export: Optional[bool],
                 sharded_apply: Optional[bool]):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.names = names
        self.tensors = tensors
        self.compression = compression
        self.min_compress_bytes = min_compress_bytes
        self.stream_export = stream_export
        self.sharded_apply = sharded_apply
        self.spans = StepSpans()
        self.counters: Dict[str, Any] = {}
        # the host clock (time.perf_counter) at the last step's last
        # completion: the apply's tail is measured from it
        self.last_completion = 0.0
        self._client = None
        self._registry = None         # CompressedRegistry of the client
        # the per-leaf step, or None for one optimizer.step() after the
        # drain
        self._leaf_apply = make_leaf_apply(optimizer)
        self._hooks: List = []
        self._hook_key = None
        self._worker: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._round: Optional[_Export] = None   # read by the hooks
        self._pending: Tuple[List, List] = ([], [])  # leases, h2d events
        self._streams: Dict[Tuple[str, torch.device], Any] = {}

    # ---- plumbing ----------------------------------------------------- #

    def _stream(self, kind: str, device: torch.device):
        s = self._streams.get((kind, device))
        if s is None:
            s = self._streams[(kind, device)] = torch.cuda.Stream(device)
        return s

    def _fusion(self, state) -> Tuple[int, int]:
        """(fusion threshold, bucket cap) in bytes: a bucket stays one
        key, and with host codecs under a compression threshold it stays
        below it, so the leaves the threshold keeps dense stay dense."""
        fusion = state.config.fusion_bytes
        cap = min(4 << 20, state.config.partition_bytes)
        mcb = self._mcb(state)
        if self.compression is not None and mcb > 0:
            fusion, cap = min(fusion, mcb), min(cap, mcb - 1)
        return fusion, cap

    def _mcb(self, state) -> int:
        return state.config.min_compress_bytes \
            if self.min_compress_bytes is None else self.min_compress_bytes

    def _arm_hooks(self, state, fusion: int) -> None:
        """Hooks on the leaves that stream (at least ``fusion`` bytes),
        re-armed when the setting changes."""
        on = state.config.stream_export if self.stream_export is None \
            else self.stream_export
        eligible = frozenset(
            i for i, t in enumerate(self.tensors)
            if on and t.numel() and t.numel() * t.element_size() >= fusion)
        if self._hook_key != eligible:
            self._remove_hooks()
            ref = weakref.ref(self)

            def hook(p, i):
                step = ref()
                if step is not None:
                    step._on_grad(i, p)

            self._hooks = [self.tensors[i].register_post_accumulate_grad_hook(
                lambda p, i=i: hook(p, i)) for i in sorted(eligible)]
            self._hook_key = eligible

    def _remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks, self._hook_key = [], None

    def close(self) -> None:
        """Remove the backward hooks, release the last step's slots and
        stop the export worker. The step can run again afterwards."""
        self._remove_hooks()
        self._release_pending()
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        """The backward's hook for leaf ``i``: start the copy, enqueue."""
        rnd = self._round
        if rnd is None:
            return      # a backward outside the step
        rnd.began()
        g = p.grad
        lease = rnd.checkout(self.names[i] + ":out",
                             g.numel() * g.element_size(), tag="export")
        dst = lease.tensor.view(g.dtype)
        flat = g.reshape(-1)
        ev = None
        if g.is_cuda:
            side = self._stream("d2h", g.device)
            side.wait_stream(torch.cuda.current_stream(g.device))
            with torch.cuda.stream(side):
                dst.copy_(flat, non_blocking=True)
            flat.record_stream(side)
            ev = torch.cuda.Event()
            ev.record(side)
        else:
            dst.copy_(flat)
        fut = self._worker.submit(self._ingest, rnd, i, ev, lease, g.dtype)
        rnd.futures[i] = (fut, lease)

    def _ingest(self, rnd: _Export, i: int, ev, lease, dtype):
        """Export worker: wait for leaf ``i``'s copy, submit it at its
        production-order priority. Returns its handle."""
        if ev is not None:
            ev.synchronize()
        flat = lease.array(_np_dtype(dtype))
        return self._submit(rnd, self.names[i], flat, production=True)

    def _submit(self, rnd: _Export, name: str, flat: np.ndarray,
                production: bool = False):
        """One key's round, pushed from and landing in ``flat`` (its arena
        slot): dense, or through the host codecs. Returns the handle."""
        from ..server.client import get_or_init_ctx
        state = rnd.state
        if self._registry is not None:
            ctx = self._registry.get(state, name, flat).ctx
        else:
            ctx = get_or_init_ctx(state, name, flat)
        pr = state.scheduler.production_priority(ctx) if production \
            else None
        rnd.pushed(flat.nbytes)
        if self._registry is not None:
            hid = self._registry.push_pull_async(state, name, flat, True,
                                                 priority=pr, out=flat)
            handle = state.handles.get(hid)
        else:
            handle = state.handles.allocate(name)
            state.scheduler.submit(ctx, flat, handle, True,
                                   state.config.num_workers,
                                   version=state.next_version(name),
                                   priority=pr, out=flat)
        rnd.handles.append(handle)
        return handle

    def _release_pending(self) -> None:
        leases, events = self._pending
        self._pending = ([], [])
        for ev in events:
            ev.synchronize()
        for lease in leases:
            lease.release()

    # ---- the step ----------------------------------------------------- #

    def __call__(self, batch):
        from ..core.state import get_state
        state = get_state().require()
        dev = state.device
        cuda = dev.type == "cuda"
        self._release_pending()
        self.spans.start(dev)
        self.optimizer.zero_grad(set_to_none=True)
        if state.ps_client is None:
            loss, grads = _dp_mean_grads(self.loss_fn, batch, self.tensors,
                                         state.group)
            self.spans.mark("forward_backward")
            for t, g in zip(self.tensors, grads):
                t.grad = g
            self.optimizer.step()
            self.spans.mark("apply")
            return loss
        if self._client is not state.ps_client:
            self._client = state.ps_client
            self._registry = None
            if self.compression is not None:
                from ..server.compressed import CompressedRegistry
                self._registry = CompressedRegistry(
                    state.ps_client, state.config.num_workers,
                    self.compression, self._mcb(state))
        sharded = state.config.sharded_apply if self.sharded_apply is None \
            else self.sharded_apply
        leaf_apply = self._leaf_apply if sharded else None
        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="bps-export")
        fusion, cap = self._fusion(state)
        self._arm_hooks(state, fusion)
        pushed0 = state.scheduler.bytes_pushed
        rnd = _Export(state)
        self._round = rnd
        try:
            loss, ready = self._export(state, rnd, batch, fusion, cap, cuda)
            events = self._drain(state, rnd, ready, leaf_apply, cuda)
        except BaseException:
            self._abandon(state, rnd)
            raise
        finally:
            self._round = None
        self._pending = (rnd.leases, events)
        self.counters["bytes_pushed"] = \
            state.scheduler.bytes_pushed - pushed0
        return loss

    def _export(self, state, rnd: _Export, batch, fusion: int, cap: int,
                cuda: bool):
        """Forward, backward (the hooks stream their leaves), then the
        post-backward export of the rest. Returns (loss, [(members,
        handle, lease)]) in submission order."""
        dev = state.device
        loss = self.loss_fn(batch)
        t_bwd = time.perf_counter()
        loss.backward()
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        t_end = time.perf_counter()
        with rnd._mu:
            before_end = rnd.submitted_bytes
        self.spans.mark("forward_backward")
        streamed = sorted(rnd.futures)
        post = [i for i in range(len(self.tensors)) if i not in rnd.futures]
        groups, bucket, bucket_bytes = [], [], 0
        for i in post:
            t = self.tensors[i]
            nb = t.numel() * t.element_size()
            if nb == 0:
                continue
            if nb < fusion:
                if bucket and (self.tensors[bucket[0]].dtype != t.dtype
                               or bucket_bytes + nb > cap):
                    groups.append(bucket)
                    bucket, bucket_bytes = [], 0
                bucket.append(i)
                bucket_bytes += nb
            else:
                if bucket:
                    groups.append(bucket)
                    bucket, bucket_bytes = [], 0
                groups.append([i])
        if bucket:
            groups.append(bucket)
        if groups:
            rnd.began()
        staged = []
        for g in groups:
            sizes = [self.tensors[i].numel() for i in g]
            name = self.names[g[0]] if len(g) == 1 else fused_key(
                [(self.names[i], n) for i, n in zip(g, sizes)])
            dtype = self.tensors[g[0]].dtype
            if self._registry is not None:
                dtype = torch.float32       # the codecs' wire is f32
            esize = torch.empty((), dtype=dtype).element_size()
            lease = rnd.checkout(name + ":out", sum(sizes) * esize)
            dst = lease.tensor.view(dtype)
            members, off = [], 0
            for i, n in zip(g, sizes):
                grad = self.tensors[i].grad
                if grad is None:
                    dst[off: off + n].zero_()
                else:
                    dst[off: off + n].copy_(grad.reshape(-1),
                                            non_blocking=cuda)
                members.append((i, off, n))
                off += n
            staged.append((name, members, lease, dtype))
        if cuda and staged:
            torch.cuda.current_stream(dev).synchronize()
        ready = []
        for i in streamed:
            fut, lease = rnd.futures[i]
            ready.append(([(i, 0, self.tensors[i].numel())], fut.result(),
                          lease))
        for name, members, lease, dtype in staged:
            handle = self._submit(rnd, name, lease.array(_np_dtype(dtype)))
            ready.append((members, handle, lease))
        with rnd._mu:
            first, last = rnd.first_export, rnd.last_submit
            first_push = rnd.first_push
        if first is not None and last is not None:
            self.spans.add("export", (last - first) * 1e3)
        self.counters.update(
            ttfp_ms=None if first_push is None else (first_push - t_bwd) * 1e3,
            bytes_before_backward_end=before_end,
            leaves_streamed=len(streamed),
            leaves_post_backward=sum(len(g) for g in groups),
            fused_buckets=sum(len(g) > 1 for g in groups))
        rnd.t_backward_end = t_end
        return loss.detach(), ready

    def _drain(self, state, rnd: _Export, ready: list, leaf_apply,
               cuda: bool) -> List:
        """Land every aggregate in completion order; returns the copy
        events that the next step waits for before reusing the slots."""
        dev = state.device
        done: "queue.Queue" = queue.Queue()
        for wi, (_, handle, _) in enumerate(ready):
            handle.add_done_callback(
                lambda wi=wi: done.put((wi, time.perf_counter())))
        events, last_done = [], rnd.t_backward_end
        h2d_ms = apply_ms = 0.0
        compute = torch.cuda.current_stream(dev) if cuda else None
        for _ in range(len(ready)):
            wi, t_done = done.get()
            last_done = max(last_done, t_done)
            members, handle, lease = ready[wi]
            state.handles.wait_and_clear(handle.id)   # raises its error
            src = lease.tensor.view(
                torch.float32 if self._registry is not None
                else self.tensors[members[0][0]].dtype)
            for i, off, n in members:
                p = self.tensors[i]
                if p.grad is None:
                    p.grad = torch.empty_like(p)
                t0 = time.perf_counter()
                if cuda:
                    # p.grad's last writer (the backward) has finished
                    h2d = self._stream("h2d", dev)
                    with torch.cuda.stream(h2d):
                        p.grad.view(-1).copy_(src[off: off + n],
                                              non_blocking=True)
                    p.grad.record_stream(h2d)
                    ev = torch.cuda.Event()
                    ev.record(h2d)
                    compute.wait_event(ev)
                    events.append(ev)
                    if self.spans.enabled:
                        ev.synchronize()
                else:
                    p.grad.view(-1).copy_(src[off: off + n])
                t1 = time.perf_counter()
                h2d_ms += (t1 - t0) * 1e3
                if leaf_apply is not None:
                    leaf_apply.step(p)
                    if self.spans.enabled and cuda:
                        compute.synchronize()
                    apply_ms += (time.perf_counter() - t1) * 1e3
        self.last_completion = last_done
        self.spans.add("wire", (last_done - rnd.t_backward_end) * 1e3)
        self.spans.add("h2d", h2d_ms)
        if leaf_apply is None:
            t1 = time.perf_counter()
            self.optimizer.step()
            if self.spans.enabled and cuda:
                compute.synchronize()
            apply_ms = (time.perf_counter() - t1) * 1e3
        self.spans.add("apply", apply_ms)
        return events

    def _abandon(self, state, rnd: _Export) -> None:
        """Error path: let the export worker finish what it started, then
        drop the step's handles and never recycle its slots (a reply may
        still be written into them)."""
        for fut, _ in list(rnd.futures.values()):
            try:
                fut.result(timeout=120)
            except Exception:  # noqa: BLE001 - the step's error is raised
                pass
        for h in rnd.handles:
            state.handles.discard(h.id)
        for lease in rnd.leases:
            lease.abandon()


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype
