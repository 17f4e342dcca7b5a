"""Train-step construction.

Port of byteps_tpu/jax/train.py: ``make_train_step`` (:37-85),
``make_zero_train_step`` and ``init_zero_state`` (:108-170, :2008-2020),
``make_ps_train_step`` (:562-1920), its device-compressed tier (:875-895)
and its host tier (:928-1874), and ``make_async_ps_train_step``
(:1921-2005). The JAX steps are compiled programs over
the mesh; here they are eager: forward and backward on the local batch,
the gradient round, then the optimizer. The returned loss is the mean
over the ``dp`` group, like the JAX step's ``pmean``.

The PS steps report to the measurement plane (byteps_tpu/jax/train.py
:822-894, :925-976, :1076-1078, :1603, :1864): each step opens a
StepReport (``state.profiler``) and closes it with its export, health and
carry fields; the first step of each plan counts its forward's and
backward's FLOPs (``core/ledger.py`` ``count_flops``) into the ledger's
cost model; the host tier counts ``export/*`` bytes and records
``step/h2d_update_us`` and ``step/allgather_us``, taps the health
collector on each pulled aggregate in its host slot, raises the NaN
guard's error after the report is closed (``raise_if_fatal``), and
honours BYTEPS_CHAOS_NAN_LEAF="<substr>[@<step>]" (``_chaos_nan_poison``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.push_pull import (
    _average_, gather_leaf, padded_flat, scatter_leaf, shard_layout,
)
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


@dataclasses.dataclass
class ZeroState:
    """One rank's ZeRO-1 optimizer state: ``shards[i]`` is this rank's
    flat 1/N shard of leaf ``names[i]`` (``named_leaves`` order, padded
    as ``shard_layout`` pads), and ``optimizer`` steps over the shards,
    so each per-element state buffer is 1/N of its leaf."""

    names: List[str]
    shards: List[torch.Tensor]
    optimizer: torch.optim.Optimizer
    group: Any

    def state_bytes(self) -> int:
        """Bytes of the optimizer's per-element state on this rank (its
        scalars, such as Adam's step, left out)."""
        return sum(t.numel() * t.element_size()
                   for st in self.optimizer.state.values()
                   for t in st.values()
                   if isinstance(t, torch.Tensor) and t.dim() > 0)


def init_zero_state(params, make_optimizer: Callable, group=None
                    ) -> ZeroState:
    """The ZeRO-1 state of ``params`` (a nested dict of tensors or an
    ``nn.Module``): every leaf reduce-scattered (mean) over the group
    into this rank's flat shard, and ``make_optimizer(shards)`` over them
    (``tx.init(shards)`` in the JAX package)."""
    if group is None:
        from ..core.state import get_state
        group = get_state().require().group
    leaves = named_leaves(params)
    with torch.no_grad():
        shards = [torch.nn.Parameter(scatter_leaf(p.detach(), group,
                                                  average=True))
                  for _, p in leaves]
    return ZeroState([n for n, _ in leaves], shards, make_optimizer(shards),
                     group)


def make_zero_train_step(loss_fn: Callable, params, zero_state: ZeroState):
    """The ZeRO-1 step over ``zero_state.group``: ``loss_fn(batch) ->
    scalar`` on the local batch (a closure over ``params``). Each step
    runs the backward, reduce-scatters (mean) the gradients into the
    shards' ``.grad``, copies this rank's slice of the replicated
    parameters into the shards (the JAX step reduce-scatters them, as it
    keeps no shards; the mean of equal values is that slice), runs
    ``optimizer.step()`` over the shards and all-gathers them back into
    the parameter tensors in place, so a module's parameters stay the same
    objects and stay replicated. Returns ``step(batch) -> loss``, the loss
    meaned over the group."""
    group = zero_state.group
    leaves = named_leaves(params)
    if [n for n, _ in leaves] != zero_state.names:
        raise ValueError("make_zero_train_step: the parameters are not the "
                         "leaves of zero_state")
    tensors = [p for _, p in leaves]
    shards = zero_state.shards
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def step(batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        with torch.no_grad():
            for p, g, s in zip(tensors, grads, shards):
                s.grad = scatter_leaf(g if g is not None
                                      else torch.zeros_like(p), group,
                                      average=True)
                k = s.numel()
                s.copy_(padded_flat(p, n)[rank * k:(rank + 1) * k])
            del grads
            zero_state.optimizer.step()
            for p, s in zip(tensors, shards):
                s.grad = None
                p.copy_(gather_leaf(s, p, group))
        loss = loss.detach().clone()
        if n > 1:
            dist.all_reduce(loss, group=group)
            loss /= n
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

    With a ``dp`` group of more than one process the group is one PS
    worker: each gradient is first reduced over the group (the mean, the
    intra-node reduce of BytePS); the local root pushes whole-leaf keys
    and buckets and broadcasts each aggregate, and every rank applies it.
    ``local_shard_export`` (default BYTEPS_LOCAL_SHARD_EXPORT) on the
    dense streamed host tier reduce-scatters each leaf of at least
    max(fusion, BYTEPS_SHARD_MIN_BYTES) bytes (padding at most 1/8)
    instead, each rank pushes its own shard under the JAX package's shard
    key, and the drain all-gathers the shards before the per-leaf apply.

    ``rowsparse_params`` (substrings of gradient names, e.g.
    ``("embed",)``): a matching 2-D gradient travels row-sparse, only its
    nonzero rows on the push wire, and takes precedence over
    ``compression`` (``_route_rowsparse``). The host tier leaves it out
    of the streamed export, the shard plan and the buckets and submits it
    after the backward; the device tier sends it through the host while
    the rest compress on the card. A match that is not 2-D warns once
    and stays on its tier's path.

    Under cross-barrier bounded staleness (BYTEPS_CROSS_BARRIER,
    BYTEPS_STALENESS) the host tier may carry the back half's rounds into
    the next step (``HostTierStep``); ``step.flush()`` lands them.

    Returns ``step(batch) -> loss`` (a detached scalar, the dp mean).
    ``step.close()`` removes what the step holds on the parameters (the
    host tier's backward hooks) and stops its threads; call it when
    done with the step."""
    named = named_leaves(params)
    names = ["grad/" + n for n, _ in named]
    tensors = [t for _, t in named]
    rowsparse = tuple(rowsparse_params or ())
    if compression is None or not device_compress:
        return HostTierStep(loss_fn, optimizer, names, tensors, compression,
                            min_compress_bytes, stream_export,
                            sharded_apply, local_shard_export, rowsparse)
    return _device_tier_step(loss_fn, optimizer, names, tensors,
                             compression, min_compress_bytes, rowsparse)


def make_async_ps_train_step(loss_fn: Callable, optimizer, params):
    """The asynchronous data-parallel step (BYTEPS_ENABLE_ASYNC;
    byteps_tpu/jax/train.py:1921-2005, BytePS's torch/__init__.py:188-216
    and server.cc:315-319): each step is the local step (forward,
    backward, the ``dp`` mean, ``optimizer.step()``), then for each leaf
    the weight delta (the new weights minus the old, on the card) goes to
    the server, which adds it into the weights it holds with no barrier
    of the workers, and the server's weights come back into the
    parameter. The workers never wait for each other; their staleness is
    the price.

    The servers must run with BYTEPS_ENABLE_ASYNC=1. Each leaf's key is
    ``"asyncw/" + path`` and is seeded with the worker's weights before
    its first update (``PSClient.init_weights``: the first worker's init
    wins, so start the workers from the same or broadcast weights). A
    partition is seeded again wherever the client has no init of it: on
    a resumed client, and on the new server of a key that a join or a
    drain moved, from the weights the worker last pulled (with several
    workers, a peer's delta folded into the old server after that pull
    is lost to the new one; the JAX step instead fails the push there,
    ROADMAP.md §C.13). Every leaf's delta goes out at once, and the step
    waits once for all the weights. In a dp group the root alone pushes
    and pulls, and broadcasts the weights. Without a PS the step is the
    plain local step (the JAX step adds the delta back to
    the old weights instead, within an ulp of it). The optimizer's state
    stays the worker's own.

    Returns ``step(batch) -> loss`` (a detached scalar, the dp mean);
    ``step.counters["bytes_pushed"]`` and ``["bytes_pulled"]`` are the
    last step's delta and weight bytes."""
    from ..core.state import get_state
    from ..core.types import host_array, host_tensor

    named = named_leaves(params)
    names = ["asyncw/" + n for n, _ in named]
    tensors = [t for _, t in named]
    counters: Dict[str, int] = {"bytes_pushed": 0, "bytes_pulled": 0}

    def step(batch):
        state = get_state().require()
        with on_card(state.device):
            return _step(state, batch)

    def _step(state, batch):
        optimizer.zero_grad(set_to_none=True)
        loss, grads = _dp_mean_grads(loss_fn, batch, tensors, state.group)
        client = state.ps_client
        old = [t.detach().clone() for t in tensors] \
            if client is not None else None
        for t, g in zip(tensors, grads):
            t.grad = g
        optimizer.step()
        if client is None:
            return loss
        # every rank declares the keys alike, in flatten order
        ctxs = [_declare(state, name, t.numel(), t.dtype)
                for name, t in zip(names, tensors)]
        if state.is_root:
            for ctx, w in zip(ctxs, old):
                if client.uninited(ctx):
                    client.init_weights(ctx, host_array(w.reshape(-1))[0])
            deltas = [host_array((t.detach() - o).reshape(-1))
                      for t, o in zip(tensors, old)]
            pulled = client.push_delta_pull_weights(
                ctxs, [d for d, _ in deltas])
            with torch.no_grad():
                for t, w, (_, wire) in zip(tensors, pulled, deltas):
                    t.copy_(host_tensor(w, wire).reshape(t.shape))
            nbytes = sum(d.nbytes for d, _ in deltas)
            counters.update(bytes_pushed=nbytes, bytes_pulled=nbytes)
        else:
            counters.update(bytes_pushed=0, bytes_pulled=0)
        if dist.get_world_size(state.group) > 1:
            with torch.no_grad():
                for t in tensors:
                    dist.broadcast(t.data, src=0, group=state.group)
        return loss

    step.counters = counters
    return step


# names already warned about by _route_rowsparse
_rowsparse_warned: set = set()
# BYTEPS_CHAOS_NAN_LEAF specs already fired in this process
_chaos_nan_fired: set = set()


def _chaos_nan_poison(spec: str, name: str, flat: np.ndarray,
                      step_no: int) -> None:
    """BYTEPS_CHAOS_NAN_LEAF="<substr>[@<step>]" (byteps_tpu/jax/train.py
    :170-197): the first push of a key whose name holds ``<substr>`` at
    or after step ``<step>`` (default 3) carries one NaN, once per
    process and spec: the chaos test of the health plane's detect, flight
    event and guard. ``flat`` is the key's host slot, poisoned in place
    (the aggregate lands in it afterwards)."""
    sub, _, at = spec.partition("@")
    try:
        at_step = int(at) if at else 3
    except ValueError:
        at_step = 3
    if spec in _chaos_nan_fired or step_no < at_step \
            or not sub or sub not in name:
        return
    _chaos_nan_fired.add(spec)
    flat.reshape(-1)[0] = np.nan
    from ..core import flight
    from ..utils.logging import log
    flight.record("chaos_nan_injected",
                  detail=f"{name} step={step_no} spec={spec}")
    log.warning("CHAOS: injected NaN into %r push at step %d "
                "(BYTEPS_CHAOS_NAN_LEAF=%s)", name, step_no, spec)


def _plan_cost(state, holder: dict, names: List[str],
               tensors: List[torch.Tensor], run: Callable):
    """``run()``'s result. On the first step of a plan (the leaves'
    names, shapes and dtypes, and the ledger it registers with) ``run``,
    the forward and backward, goes under ``core/ledger.py``
    ``count_flops``, and its FLOPs and the plan's ideal exchange bytes
    (each leaf once each way) become the ledger's cost model, as JAX
    caches ``jit_cost`` per plan (byteps_tpu/jax/train.py:838-870)."""
    ledger = state.ledger
    if ledger is None or not ledger.enabled:
        return run()
    key = tuple((n, tuple(t.shape), t.dtype) for n, t in zip(names, tensors))
    if holder.get("cost_key") == key and holder.get("cost_ledger") is ledger:
        return run()
    from ..core.ledger import count_flops
    out, flops, counted = count_flops(run)
    if not counted:
        return out          # another step was counting: the next step
    holder["cost_key"], holder["cost_ledger"] = key, ledger
    ledger.register_step_cost(
        flops=flops, ideal_wire_bytes=2 * sum(
            t.numel() * t.element_size() for t in tensors),
        source="flop_counter" if flops else "none")
    return out



def _rowsparse_match(name: str, rowsparse_params) -> bool:
    return any(s in name for s in rowsparse_params)


def _route_rowsparse(name: str, t: torch.Tensor, rowsparse_params) -> bool:
    """The routing of both tiers (byteps_tpu/jax/train.py:496-512): a
    gradient whose name matches ``rowsparse_params`` rides the row-sparse
    wire when it is 2-D; any other match warns once and keeps its tier's
    path. (The scheduler the JAX predicate also asks for runs whenever a
    PS client does.)"""
    if not _rowsparse_match(name, rowsparse_params):
        return False
    if t.dim() == 2:
        return True
    if name not in _rowsparse_warned:
        from ..utils.logging import log
        _rowsparse_warned.add(name)
        log.warning("rowsparse_params matched %r but the gradient is not "
                    "2D (shape %s): using the dense path", name,
                    tuple(t.shape))
    return False


def _submit_rowsparse(state, name: str, host2d: np.ndarray, out=None):
    """(handle, payload bytes) of the averaged row-sparse round of a host
    [rows, width] f32 gradient."""
    from ..server.client import rowsparse_submit
    handle = state.handles.allocate(name)
    return handle, rowsparse_submit(state, name, host2d, True, handle,
                                    out=out)


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
                      min_compress_bytes, rowsparse=()):
    """The device-compressed tier (byteps_tpu/jax/train.py:875-895):

    1. forward and backward on the local batch;
    2. the ``dp`` reduce (mean; nothing to do for a group of one);
    3. one device-compressed PS round over the named gradients: compress
       on the card, fused PUSHPULL through the scheduler to the C++
       server, decompress the aggregate on the card; with a ``dp`` group
       of more than one, the local root alone runs the round (one EF
       state per key, as the one JAX process does on the psum'd
       gradient) and broadcasts each aggregate;
    4. ``optimizer.step()`` on the averaged gradients.

    A leaf that ``rowsparse`` routes (``_route_rowsparse``) leaves the
    device round: it is copied to the host and sent row-sparse, submitted
    (and so declared) before the round as the JAX step submits it
    (byteps_tpu/jax/train.py:515-560), and waited for after it."""
    from ..core.state import get_state
    from .device_compression import DeviceCompressor

    comp_state: Dict[str, Any] = {"client": None, "device": None}
    spans = StepSpans()

    def step(batch):
        state = get_state().require()
        with on_card(state.device):
            return _step(state, batch)

    def _step(state, batch):
        spans.start(state.device)
        optimizer.zero_grad(set_to_none=True)
        prof = state.profiler.begin_step() \
            if state.ps_client is not None else None
        loss, grads = _plan_cost(
            state, comp_state, names, tensors,
            lambda: _dp_mean_grads(loss_fn, batch, tensors, state.group)) \
            if state.ps_client is not None else \
            _dp_mean_grads(loss_fn, batch, tensors, state.group)
        spans.mark("forward_backward")
        sparse = [i for i, (nm, t) in enumerate(zip(names, tensors))
                  if state.ps_client is not None
                  and _route_rowsparse(nm, t, rowsparse)]
        dense = [i for i in range(len(names)) if i not in sparse]
        if state.ps_client is not None and not state.is_root:
            # the keys the root declares, declared alike and in its order
            for i in sparse:
                _declare(state, names[i], tensors[i].numel(), torch.float32,
                         align=tensors[i].shape[1] * 4)
            for i in dense:
                if tensors[i].numel():
                    _declare(state, names[i], tensors[i].numel(),
                             torch.float32)
            for g in grads:
                dist.broadcast(g, src=0, group=state.group)
        elif state.ps_client is not None:
            client = state.ps_client
            if comp_state["client"] is not client:
                mcb = min_compress_bytes
                if mcb is None:
                    mcb = state.config.min_compress_bytes
                comp_state["device"] = DeviceCompressor(
                    client, state.config.num_workers, compression, mcb)
                comp_state["client"] = client
            handles = {i: _submit_rowsparse(
                state, names[i],
                grads[i].detach().to(torch.float32).cpu().numpy())[0]
                for i in sparse}
            out = comp_state["device"].push_pull_leaves(
                state, [names[i] for i in dense], [grads[i] for i in dense],
                spans=spans) if dense else []
            for i, g in zip(dense, out):
                grads[i] = g
            for i, h in handles.items():
                agg = state.handles.wait_and_clear(h.id)
                grads[i] = torch.from_numpy(agg).to(
                    device=grads[i].device, dtype=grads[i].dtype)
            if state.local_size > 1:
                grads = [g.contiguous() for g in grads]
                for g in grads:
                    dist.broadcast(g, src=0, group=state.group)
        if prof is not None:
            # the round is one piece (compute and wire in one call, as in
            # the JAX tier): compute covers it and the optimizer is the
            # tail; overlap is not priced, since every wire span would
            # read as under compute
            prof.monolithic = True
            prof.mark("export_done")
            prof.mark("drain_done")
        for t, g in zip(tensors, grads):
            t.grad = g
        optimizer.step()
        spans.mark("optimizer")
        state.profiler.end_step(prof, fallback=len(names))
        return loss

    step.spans = spans
    step.device_compressor = lambda: comp_state["device"]
    step.close = lambda: None       # it holds nothing on the parameters
    step.flush = lambda: None       # it carries nothing across steps
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

    def __init__(self, state, n_dp: int = 1,
                 shards: Optional[Dict[int, dict]] = None,
                 carry: frozenset = frozenset(), par: int = 0):
        self.state = state
        self.n_dp = n_dp                 # the dp group's size
        self.shards = shards or {}       # leaf -> its shard plan
        # cross-barrier: the leaves whose round may drain in the next
        # step, and the step's parity, which picks their slots
        self.carry = carry
        self.par = par
        # streamed leaf -> (the worker's future of its handle, its slot);
        # (None, None) on a rank that pushes nothing for the leaf
        self.futures: Dict[int, tuple] = {}
        # dp > 1: the hooks' collectives on leaves this rank does not
        # push, and the tensors every collective of the hooks reads
        self.works: List = []
        self.keep: List = []
        self.leases: List = []
        self.handles: List = []
        self.t_backward_end = 0.0
        # the measurement plane: the open StepReport (or None), the health
        # collector (or None), the chaos spec (or None), the registry
        self.prof = None
        self.hc = None
        self.chaos: Optional[str] = None
        self.metrics = state.metrics
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

    def slot_key(self, i: Optional[int], name: str) -> str:
        """The arena key of a key's result slot: a carry-eligible leaf
        alternates two slots by step parity, since its last round may
        still be landing in one (byteps_tpu/jax/train.py:1024-1031)."""
        if i in self.carry:
            return f"{name}:out~x{self.par}"
        return name + ":out"

    def checkout(self, key: str, nbytes: int, tag=None):
        lease = self.state.arena.checkout(key, nbytes, tag=tag)
        with self._mu:
            self.leases.append(lease)
        return lease


def _count_export(rnd: _Export, nbytes: int, shard: bool) -> None:
    """A key's bytes off the card (byteps_tpu/jax/train.py:1059-1098,
    :1492): a whole leaf's under ``export/whole_bytes``, a shard's under
    ``export/shard_bytes``, each under this rank's
    ``export/device_bytes/<rank>`` too."""
    m = rnd.metrics
    rank = rnd.state.local_rank
    m.counter("export/shard_bytes" if shard else "export/whole_bytes"
              ).inc(nbytes)
    m.counter(f"export/device_bytes/{rank}").inc(nbytes)


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

    With a ``dp`` group of more than one process (one PS worker):

    - each hook first starts the leaf's async all-reduce (the mean) over
      the group, NCCL on the card, BytePS's intra-node reduce; the
      root's side stream waits on that one collective before its copy,
      and the root alone pushes whole-leaf keys and buckets (the
      post-backward groups reduce the same way, whole);
    - the locality-shard plan (``_shard_plan``, the JAX gates of
      :1205-1280): a leaf in it reduce-scatters instead, and every rank
      copies and pushes its own shard under its shard key (``submit_shard``
      :1063, at the parent leaf's production priority), streamed or, for
      a leaf no hook exported, after the backward (``submit_shard_fallback``
      :1079);
    - the drain (``_drain``): the root takes its keys in completion
      order and broadcasts each one's index, so every rank lands the
      same key next: a whole-leaf key or bucket is broadcast from the
      root; a shard leaf is copied to the card shard by shard, each rank
      its own, and all-gathered (``land_shard`` :1632, its branch for an
      update that is not split by shard: the gradient is gathered and
      the step is per leaf, so the parameters stay the same on every
      rank). Per-shard optimizer state is ZeRO's and not ported.

    A hook that fails raises out of the backward: there is no quiet
    switch to another path (the JAX package's ``_disable_stream``). The
    hooks hold the step weakly; ``close()`` removes them and stops the
    export worker.
    Row-sparse leaves (``rowsparse``): out of the hooks, the shard plan
    and the buckets; after the backward each is reduced like a whole leaf,
    copied into its slot and submitted row-sparse by the root
    (``_submit_rowsparse``); its dense f32 aggregate lands in that slot
    and through the same drain and per-leaf apply.

    Cross-barrier bounded staleness (BYTEPS_CROSS_BARRIER with
    BYTEPS_STALENESS > 0 on the fused PUSHPULL: the scheduler's
    ``xb_window``; byteps_tpu/jax/train.py:1322-1360, 1515-1575,
    1686-1710): with the per-leaf apply and no host codec, the step
    returns once every key but the carry-eligible ones (``_carry_set``:
    dense whole-leaf keys of the back half of the model) has landed;
    those land too if their reply is already in, and are otherwise
    carried: their slots (two per leaf, alternating by step parity) stay
    leased, and the next step lands them and runs their optimizer steps
    after its own export, before its own drain. Their parameters stay
    one update behind meanwhile. ``flush()`` lands what is still
    carried. The server must run with the same two variables. In a dp
    group the root, the one rank that pushes whole leaves and so sees
    their replies, decides what lands and what is carried: the drain
    broadcasts each landed key's index and then the end of the step's
    landing, so every rank carries the same leaves (with the same slot
    parity); the next step, and ``flush()``, which every rank calls,
    land them on every rank in the same order, each aggregate broadcast
    from the root.

    The measurement plane (byteps_tpu/jax/train.py:822-1872): each step
    opens a StepReport; ``compute_ms`` ends when the last leaf's copy to
    the host has completed, ``drain_ms`` when the last aggregate has
    landed and its optimizer step is queued; the drain's blocked time is
    ``pull_wait_ms``, each leaf's copy and step an ``H2D_UPDATE`` sample
    (and ``step/h2d_update_us``), each shard gather an ``ALLGATHER`` one.
    With BYTEPS_HEALTH, in one process (not a dp group), the collector
    reads each aggregate in its host slot, carried ones too.

    Across fleet changes: after a ``suspend``/``resume`` the step meets
    a new client and makes its host-codec registry, shard keys and
    streamed keys' inits again on it; after a join or a drain (a new
    routing version) it inits the moved keys on their new servers
    (``ensure_init``, or at once for the streamed and shard keys). A
    carried round is still on the wire when a join or a drain starts:
    the elastic call waits for it to land on its old server, as the JAX
    package's quiescence does, and the next step lands it as usual; a
    suspend fails it, and the next step raises its error.

    ``spans`` (off by default): forward_backward (step start to the
    backward's end on the device), export (the first leaf handed over to
    the last submission), wire (the backward's end to the last
    completion), h2d and apply (each copy and step waited for). They
    overlap and do not sum to the step. ``counters``, set every step:
    ``ttfp_ms`` (the backward's start to the first submission),
    ``bytes_before_backward_end`` (bytes submitted before the backward's
    last kernel ended), ``leaves_streamed``, ``leaves_post_backward``,
    ``fused_buckets``, ``shard_leaves``, ``rowsparse_bytes`` (the
    row-sparse payloads), ``bytes_pushed`` (by this
    rank, retries included), the scheduler's ``retries``,
    ``server_failovers`` and ``key_migrations`` in the step, and the
    carry's ``carried_leaves`` (carried out of the step), ``carried``
    (their names), ``carry_drained`` (the last step's carry landed in
    this one) and ``carry_lag`` (the step boundaries it crossed, 1 at the
    steady state; None with nothing drained).

    A wire exchange that fails retries inside the scheduler, and a key
    whose server died moves to a survivor there (``core/scheduler.py``):
    the step sees only a later completion. Its slots stay leased until
    the next step's start, so a retried push re-sends the slot's bytes;
    a round that fails for good raises out of the drain, and the step's
    handles are dropped and its slots abandoned (``_abandon``)."""

    def __init__(self, loss_fn, optimizer, names: List[str],
                 tensors: List[torch.Tensor],
                 compression: Optional[Dict[str, str]],
                 min_compress_bytes: Optional[int],
                 stream_export: Optional[bool],
                 sharded_apply: Optional[bool],
                 local_shard_export: Optional[bool] = None,
                 rowsparse: Tuple[str, ...] = ()):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.names = names
        self.tensors = tensors
        self.compression = compression
        self.min_compress_bytes = min_compress_bytes
        self.stream_export = stream_export
        self.sharded_apply = sharded_apply
        self.local_shard_export = local_shard_export
        self.rowsparse = rowsparse
        # the locality-shard plan and what it was made for
        self._shards: Dict[int, dict] = {}
        self._shard_key = None
        self.spans = StepSpans()
        self.counters: Dict[str, Any] = {}
        # the host clock (time.perf_counter) at the last step's last
        # completion: the apply's tail is measured from it
        self.last_completion = 0.0
        self._client = None
        self._routing = None          # the registry's routing version seen
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
        # cross-barrier: the last step's rounds still to land, {"entries":
        # [(leaf, handle, lease, wire dtype)], "step": its ordinal}; the
        # step's ordinal and parity
        self._carry: Optional[dict] = None
        self._xb_seq = 0
        self._xb_par = 0
        # the ledger's cost model: the plan it was counted for
        self._cost: Dict[str, Any] = {}

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
        on = self._streams_on(state)
        eligible = frozenset(
            i for i, t in enumerate(self.tensors)
            if on and t.numel() and t.numel() * t.element_size() >= fusion
            and not _rowsparse_match(self.names[i], self.rowsparse))
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

    def _streams_on(self, state) -> bool:
        return state.config.stream_export if self.stream_export is None \
            else self.stream_export

    def _shard_plan(self, state, fusion: int, n: int) -> Dict[int, dict]:
        """The locality-shard plan (byteps_tpu/jax/train.py:1205-1280):
        leaf -> {slen, size, ctxs, names, parent} for each leaf that
        shards.
        Its gates are the JAX package's, and all are the same on every
        worker: a dp group above one, the export streamed, no host codec,
        at least max(fusion, shard_min_bytes) bytes, padding at most 1/8
        of the leaf. A new plan declares its shard keys first, in flatten
        order, each leaf's parent name after its shards (the anchor of
        their production order), and frees the keys of the old one."""
        cfg = state.config
        on = cfg.local_shard_export if self.local_shard_export is None \
            else self.local_shard_export
        plan_on = (on and n > 1 and self.compression is None
                   and self._streams_on(state))
        smin = max(fusion, cfg.shard_min_bytes)
        chosen = []
        for i, t in enumerate(self.tensors):
            nb = t.numel() * t.element_size()
            if not plan_on or nb == 0 or nb < smin or \
                    _rowsparse_match(self.names[i], self.rowsparse):
                continue
            _, pad = shard_layout(t.numel(), n)
            if pad * 8 <= t.numel():
                chosen.append(i)
        key = (n, tuple((i, self.tensors[i].numel(), self.tensors[i].dtype)
                        for i in chosen))
        if key == self._shard_key:
            return self._shards
        from ..core.types import DataType
        reg, plan = state.registry, {}
        for i in chosen:
            t = self.tensors[i]
            slen, _ = shard_layout(t.numel(), n)
            dt = DataType.from_np(_np_dtype(t.dtype))
            ctxs = reg.declare_shards(self.names[i], slen * t.element_size(),
                                      n, dt)
            plan[i] = {"slen": slen, "size": t.numel(), "ctxs": ctxs,
                       "names": [c.name for c in ctxs],
                       "parent": reg.declare(self.names[i], dt)}
        if plan and state.ps_client is not None:
            # this rank's shard keys init all at once: a peer (another
            # package's worker) may reach them in another order
            for info in plan.values():
                state.ps_client.init_async(info["ctxs"][state.local_rank])
        live = {nm for info in plan.values() for nm in info["names"]}
        for info in self._shards.values():
            for nm in info["names"]:
                if nm not in live:
                    reg.free(nm)
        self._shards, self._shard_key = plan, key
        return plan

    def _declare_streamed(self, state, shards: Dict[int, dict]) -> None:
        """Declare the keys of the leaves that stream whole, before the
        backward and in flatten order: the PS key is the declaration's
        number, and autograd produces the gradients in another order
        (``lm_head`` first). Flatten order is the order the JAX step's
        taps declare them in at the fusion thresholds where that order
        is fixed (README, the port's section), and it is the same on every
        rank of a dp group. A leaf of the shard plan has its shard keys
        declared by the plan."""
        dtype = torch.float32 if self._registry is not None else None
        for i in sorted(self._hook_key or ()):
            if i not in shards:
                t = self.tensors[i]
                ctx = _declare(state, self.names[i], t.numel(),
                               dtype or t.dtype)
                if state.is_root:
                    # each key's init is a barrier of every worker: they
                    # start all at once, as the shard plan's do
                    state.ps_client.init_async(ctx)

    def _remove_hooks(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks, self._hook_key = [], None

    def close(self) -> None:
        """Land what the cross-barrier carry holds (``flush``), remove the
        backward hooks, release the last step's slots and stop the export
        worker. The step can run again afterwards."""
        self.flush()
        self._remove_hooks()
        self._release_pending()
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        """The backward's hook for leaf ``i``: start the copy of its
        gradient (or of this rank's shard of it) to its slot, enqueue its
        submission. In a dp group the hook first starts the leaf's
        intra-node reduce, the async mean over the group (a reduce-scatter
        for a leaf of the shard plan), and the copy waits on that
        collective alone; a rank other than the root pushes no whole leaf
        and only starts the reduce."""
        rnd = self._round
        if rnd is None:
            return      # a backward outside the step
        rnd.began()
        state, n = rnd.state, rnd.n_dp
        info = rnd.shards.get(i)
        name, parent, work = self.names[i], None, None
        src = p.grad.reshape(-1)
        if info is not None:
            flat = padded_flat(p.grad, n)
            src = torch.empty(flat.numel() // n, dtype=flat.dtype,
                              device=flat.device)
            work = dist.reduce_scatter_tensor(src, flat, group=state.group,
                                              async_op=True)
            name, parent = info["names"][state.local_rank], info["parent"]
            # the collective's input and output stay alive to the step's
            # end (the padded input is a temporary)
            rnd.keep += [flat, src]
        elif n > 1:
            work = dist.all_reduce(src, group=state.group, async_op=True)
            rnd.keep.append(src)
            if not state.is_root:
                # the root pushes the leaf; its broadcast replaces the
                # mean. The key is declared here all the same, where the
                # root's export worker declares it, so that every rank's
                # registry numbers the keys alike
                _declare(state, name, src.numel(), src.dtype)
                rnd.works.append(work)
                rnd.futures[i] = (None, None)
                return
        lease = rnd.checkout(rnd.slot_key(i, name),
                             src.numel() * src.element_size(), tag="export")
        dst = lease.tensor.view(src.dtype)
        ev = None
        if src.is_cuda:
            side = self._stream("d2h", src.device)
            side.wait_stream(torch.cuda.current_stream(src.device))
            with torch.cuda.stream(side):
                if work is not None:
                    work.wait()         # the side stream waits on the reduce
                    _average_(src, n)
                dst.copy_(src, non_blocking=True)
            src.record_stream(side)
            ev = torch.cuda.Event()
            ev.record(side)
        else:
            if work is not None:
                work.wait()
                _average_(src, n)
            dst.copy_(src)
        fut = self._worker.submit(self._ingest, rnd, name, parent, ev, lease,
                                  src.dtype)
        rnd.futures[i] = (fut, lease)

    def _ingest(self, rnd: _Export, name: str, parent, ev, lease, dtype):
        """Export worker: wait for a leaf's (or a shard's) copy, submit it
        under ``name`` at its production-order priority (the ``parent``
        leaf's for a shard). Returns its handle."""
        if ev is not None:
            ev.synchronize()
        flat = lease.array(_np_dtype(dtype))
        _count_export(rnd, flat.nbytes, shard=parent is not None)
        return self._submit(rnd, name, flat, production=True, parent=parent)

    def _submit(self, rnd: _Export, name: str, flat: np.ndarray,
                production: bool = False, parent=None):
        """One key's round, pushed from and landing in ``flat`` (its arena
        slot): dense, or through the host codecs. Returns the handle."""
        from ..server.client import get_or_init_ctx
        state = rnd.state
        if self._registry is not None:
            ctx = self._registry.get(state, name, flat).ctx
        else:
            ctx = get_or_init_ctx(state, name, flat)
        pr = state.scheduler.production_priority(ctx, parent) \
            if production else None
        if rnd.chaos is not None:
            _chaos_nan_poison(rnd.chaos, name, flat,
                              rnd.prof.step if rnd.prof is not None else 0)
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
        with on_card(state.device):
            return self._step(state, batch)

    def _step(self, state, batch):
        dev = state.device
        cuda = dev.type == "cuda"
        self._release_pending()
        self.spans.start(dev)
        self.optimizer.zero_grad(set_to_none=True)
        prof = state.profiler.begin_step() \
            if state.ps_client is not None else None
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
        routing = (id(state.registry), state.registry.routing_version)
        if self._routing != routing:
            # a new client, a resume's re-partition, a join or a drain:
            # the shard plan's keys init again (on their new servers)
            self._routing, self._shard_key = routing, None
        sharded = state.config.sharded_apply if self.sharded_apply is None \
            else self.sharded_apply
        leaf_apply = self._leaf_apply if sharded else None
        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="bps-export")
        fusion, cap = self._fusion(state)
        self._arm_hooks(state, fusion)
        n_dp = dist.get_world_size(state.group)
        shards = self._shard_plan(state, fusion, n_dp)
        self._declare_streamed(state, shards)
        before = state.scheduler.counters()
        self.counters["rowsparse_bytes"] = 0
        carry = self._carry_set(state, fusion, shards, leaf_apply)
        self._xb_seq += 1
        if carry is not None:
            self._xb_par ^= 1
        rnd = _Export(state, n_dp, shards, carry or frozenset(),
                      self._xb_par)
        rnd.prof = prof
        rnd.chaos = os.environ.get("BYTEPS_CHAOS_NAN_LEAF") or None
        # the health collector taps whole aggregates in this process's
        # host slots: in a dp group another rank's shards are not there,
        # so a group's reports leave the health fields None
        if state.health is not None and prof is not None and n_dp == 1:
            rnd.hc = state.health.begin_collect(len(self.names))
        if rnd.hc is not None:
            with torch.no_grad():
                rnd.hc.param_norms_dev = torch.stack([
                    torch.linalg.vector_norm(t.detach(), dtype=torch.float32)
                    for t in self.tensors])
        # the export counters, present every step (JAX :965-976)
        metrics = state.metrics
        metrics.counter("export/shard_bytes")
        metrics.counter("export/whole_bytes")
        metrics.counter(f"export/device_bytes/{state.local_rank}")
        self._round = rnd
        xb_ms = None
        try:
            loss, ready = self._export(state, rnd, batch, fusion, cap, cuda)
            if prof is not None:
                # every leaf has left the card: the copies of the
                # streamed ones and of the rest have completed (_post)
                prof.mark("export_done")
            # the last step's carried rounds, after this step's export:
            # their pulls overlapped this step's forward and backward
            t_xb = time.perf_counter()
            events, carried, drained, lag = self._apply_carry(state, cuda,
                                                              rnd.hc)
            if drained:
                xb_ms = (time.perf_counter() - t_xb) * 1e3
                metrics.counter("barrier/carry_drained").inc(drained)
            with rnd._mu:
                rnd.leases += carried
            events += self._drain(state, rnd, ready, leaf_apply, cuda)
            if prof is not None:
                prof.mark("drain_done")
        except BaseException:
            self._abandon(state, rnd)
            raise
        finally:
            self._round = None
        self._pending = (rnd.leases, events)
        entries = self._carry["entries"] if self._carry else []
        if entries:
            metrics.counter("barrier/carried_leaves").inc(len(entries))
        self.counters.update(
            carried_leaves=len(entries), carry_drained=drained,
            carry_lag=lag,
            carried=tuple(self.names[e[0]] for e in entries))
        # bytes_pushed, and the wire's retries, server failovers and
        # migrated keys, of this step
        after = state.scheduler.counters()
        self.counters.update({k: after[k] - before[k] for k in after})
        if n_dp > 1:
            loss = loss.clone()
            dist.all_reduce(loss, group=state.group)
            loss /= n_dp
        self._close_report(state, rnd, carry is not None, drained, xb_ms,
                           lag, len(entries))
        return loss

    def _close_report(self, state, rnd: _Export, xb_on: bool, drained: int,
                      xb_ms: Optional[float], lag: Optional[int],
                      depth: int) -> None:
        """The step's export accounting and StepReport (with its health
        and carry fields), then the NaN guard's raise, after the report
        and its flight events landed (byteps_tpu/jax/train.py:1800-1872)."""
        c = self.counters
        n_streamed = c["leaves_streamed"]
        ttfp = c["ttfp_ms"]
        state.telemetry.record_export(
            n_streamed, len(self.names) - n_streamed,
            None if ttfp is None else ttfp / 1e3,
            shard_leaves=c["shard_leaves"])
        health_fields = None
        if rnd.hc is not None:
            tiers = self._registry.tiers() if self._registry is not None \
                else None
            try:
                health_fields = state.health.finalize(
                    rnd.hc, self.names, state, tiers)
            except Exception:  # noqa: BLE001 - diagnostics never kill
                health_fields = None          # the step
        xb_fields = None
        if xb_on:
            xb_fields = {"carried_leaves": drained,
                         "carry_drain_ms": xb_ms, "staleness_lag": lag,
                         "window_depth": depth}
        state.profiler.end_step(rnd.prof, ttfp_ms=ttfp, streamed=n_streamed,
                                fallback=len(self.names) - n_streamed,
                                health=health_fields, xb=xb_fields)
        if state.health is not None:
            state.health.raise_if_fatal()

    def _carry_set(self, state, fusion: int, shards: Dict[int, dict],
                   leaf_apply) -> Optional[frozenset]:
        """The leaves whose round may land after the step returns (None:
        cross-barrier staleness is off). It is on with the scheduler's
        staleness credit (BYTEPS_CROSS_BARRIER, BYTEPS_STALENESS > 0, the
        fused PUSHPULL), the per-leaf apply and no host codec, in a dp
        group of any size (the JAX step's gate, byteps_tpu/jax/train.py
        :1338, has no dp limit either). Eligible are the dense whole-leaf
        keys of the back half of the model in flatten order, at least
        ``fusion`` bytes each, outside the shard plan and the row-sparse
        wire (byteps_tpu/jax/train.py:1322-1360): the next forward reads
        the front half first."""
        if (state.scheduler.xb_window <= 0 or leaf_apply is None
                or self._registry is not None):
            return None
        def eligible(i: int) -> bool:
            nb = self.tensors[i].numel() * self.tensors[i].element_size()
            return (nb > 0 and nb >= fusion and i not in shards and
                    not _rowsparse_match(self.names[i], self.rowsparse))

        first = max(1, (len(self.tensors) + 1) // 2)
        return frozenset(filter(eligible, range(first, len(self.tensors))))

    def _apply_carry(self, state, cuda: bool, hc=None):
        """Land the last step's carried rounds: each aggregate into its
        parameter's gradient and that leaf's optimizer step, in place,
        from the values the carry left (the parameter and its optimizer
        state as the carried step found them). In a dp group every rank
        lands the same leaves in the same order, each aggregate copied to
        the card on the root and broadcast from it. Returns (the copies'
        events, the carried slots, the leaves drained, the step
        boundaries they crossed)."""
        carry, self._carry = self._carry, None
        if carry is None:
            return [], [], 0, None
        dev, group = state.device, state.group
        n = dist.get_world_size(group)
        compute = torch.cuda.current_stream(dev) if cuda else None
        events: List = []
        try:
            for i, handle, lease, wire in carry["entries"]:
                if handle is not None:
                    state.handles.wait_and_clear(handle.id)  # raises its error
                if hc is not None and lease is not None:
                    hc.leaf(i, lease.array(_np_dtype(wire)))
                p = self.tensors[i]
                if p.grad is None:
                    p.grad = torch.empty_like(p)
                if n > 1:
                    buf = torch.empty(p.numel(), dtype=wire, device=dev)
                    if state.is_root:
                        self._h2d(lease.tensor.view(wire), buf, compute,
                                  events, fresh=True)
                    dist.broadcast(buf, src=0, group=group)
                    p.grad.view(-1).copy_(buf)
                else:
                    self._h2d(lease.tensor.view(wire), p.grad.view(-1),
                              compute, events)
                self._leaf_apply.step(p)
                if compute is not None:
                    # this step's own round of the leaf may land in the
                    # same p.grad: its copy waits for this step's read
                    self._stream("h2d", p.device).wait_stream(compute)
        except BaseException:
            # a carried round that fails loses its leaf's update: the
            # step raises, as a failed drain does
            self._void_carry(state, carry)
            raise
        return (events, [e[2] for e in carry["entries"] if e[2] is not None],
                len(carry["entries"]), self._xb_seq - carry["step"])

    def _void_carry(self, state, carry: Optional[dict]) -> None:
        if carry is not None:
            for _, handle, lease, _ in carry["entries"]:
                if handle is not None:
                    state.handles.discard(handle.id)
                if lease is not None:
                    lease.abandon()

    def flush(self) -> None:
        """Drain the cross-barrier carry: each carried leaf's aggregate
        lands and its optimizer step runs, in place. Call it after the
        last step of a run (or before a checkpoint), on every rank of a dp
        group; a second call, or one with nothing carried, does nothing
        (byteps_tpu/jax/train.py:1874-1917)."""
        if self._carry is None:
            return
        from ..core.state import get_state
        state = get_state().require()
        with on_card(state.device):
            events, leases, _, _ = self._apply_carry(
                state, state.device.type == "cuda")
            for ev in events:
                ev.synchronize()
            for lease in leases:
                lease.release()

    def _export(self, state, rnd: _Export, batch, fusion: int, cap: int,
                cuda: bool):
        """Forward, backward (the hooks stream their leaves), then the
        post-backward export of the rest. Returns (loss, [(members,
        handle, lease)]) in submission order."""
        dev = state.device
        t_bwd = [0.0]

        def forward_backward():
            loss = self.loss_fn(batch)
            t_bwd[0] = time.perf_counter()
            loss.backward()
            return loss

        loss = _plan_cost(state, self._cost, self.names, self.tensors,
                          forward_backward)
        if cuda:
            torch.cuda.current_stream(dev).synchronize()
        t_end = time.perf_counter()
        with rnd._mu:
            before_end = rnd.submitted_bytes
        self.spans.mark("forward_backward")
        streamed = sorted(rnd.futures)
        post = [i for i in range(len(self.tensors)) if i not in rnd.futures]
        # a leaf of the shard plan that no hook exported still rides its
        # shard keys, so the key set stays every worker's
        fallback = [i for i in post if i in rnd.shards]
        groups = self._groups([i for i in post if i not in rnd.shards],
                              fusion, cap)
        if groups or fallback:
            rnd.began()
        ready = self._post(state, rnd, streamed, fallback, groups, cuda)
        with rnd._mu:
            first, last = rnd.first_export, rnd.last_submit
            first_push = rnd.first_push
        if first is not None and last is not None:
            self.spans.add("export", (last - first) * 1e3)
        self.counters.update(
            ttfp_ms=None if first_push is None
            else (first_push - t_bwd[0]) * 1e3,
            bytes_before_backward_end=before_end,
            leaves_streamed=len(streamed),
            leaves_post_backward=sum(len(g) for g in groups) + len(fallback),
            fused_buckets=sum(len(g) > 1 for g in groups),
            shard_leaves=len(rnd.shards))
        rnd.t_backward_end = t_end
        return loss.detach(), ready

    def _groups(self, post: List[int], fusion: int, cap: int) -> List[list]:
        """The post-backward keys: each leaf of at least ``fusion`` bytes
        alone, the smaller ones in buckets of one dtype up to ``cap``
        bytes (byteps_tpu/jax/train.py:1127-1170), and each row-sparse
        leaf alone, closing the bucket before it (:1494-1498)."""
        groups, bucket, bucket_bytes = [], [], 0
        for i in post:
            t = self.tensors[i]
            nb = t.numel() * t.element_size()
            if nb == 0:
                continue
            if self._sparse(i):
                if bucket:
                    groups.append(bucket)
                    bucket, bucket_bytes = [], 0
                groups.append([i])
            elif nb < fusion:
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
        return groups

    def _sparse(self, i: int) -> bool:
        return _route_rowsparse(self.names[i], self.tensors[i],
                                self.rowsparse)

    def _group_key(self, g: List[int]):
        """(key name, [(leaf, offset, length)], wire dtype) of a group."""
        sizes = [self.tensors[i].numel() for i in g]
        name = self.names[g[0]] if len(g) == 1 else fused_key(
            [(self.names[i], n) for i, n in zip(g, sizes)])
        dtype = self.tensors[g[0]].dtype
        if self._registry is not None or self._sparse(g[0]):
            dtype = torch.float32       # the codecs' and rows' wire is f32
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        return name, list(zip(g, offs, sizes)), dtype

    def _grad(self, i: int) -> torch.Tensor:
        t = self.tensors[i]
        return t.grad if t.grad is not None else torch.zeros_like(t)

    def _post(self, state, rnd: _Export, streamed: List[int],
              fallback: List[int], groups: List[list], cuda: bool) -> list:
        """After the backward: copy the post-backward keys into their
        slots and submit them. In a dp group each leaf of the shard plan
        that no hook exported reduce-scatters and every rank pushes its
        own shard; each group's gradients reduce over the group (the
        mean) and the root pushes the group's key. Returns the step's
        (members, handle, lease, shard leaf) in submission order,
        streamed leaves first: the same list on every rank, the handle
        and lease None where this rank pushes nothing."""
        n = rnd.n_dp
        # (name, members, lease, wire dtype, shard leaf, parent, sparse)
        staged = []
        for i in fallback:
            info = rnd.shards[i]
            src = scatter_leaf(self._grad(i), state.group)
            _count_export(rnd, src.numel() * src.element_size(), shard=True)
            name = info["names"][state.local_rank]
            lease = rnd.checkout(name + ":out",
                                 src.numel() * src.element_size())
            lease.tensor.view(src.dtype).copy_(src, non_blocking=cuda)
            staged.append((name, [(i, 0, self.tensors[i].numel())], lease,
                           src.dtype, i, info["parent"], False))
        for g in groups:
            name, members, dtype = self._group_key(g)
            sparse = self._sparse(g[0])
            if state.is_root:
                # each leaf's own bytes, as JAX counts before bucketing
                for i in g:
                    t = self.tensors[i]
                    _count_export(rnd, t.numel() * t.element_size(),
                                  shard=False)
            if n > 1:
                flat = torch.cat([self._grad(i).reshape(-1)
                                  for i in g]).to(dtype)
                dist.all_reduce(flat, group=state.group)
                _average_(flat, n)
                if not state.is_root:
                    _declare(state, name, flat.numel(), dtype, align=(
                        self.tensors[g[0]].shape[1] * 4 if sparse else None))
                    staged.append((name, members, None, dtype, None, None,
                                   sparse))
                    continue
            esize = torch.empty((), dtype=dtype).element_size()
            lease = rnd.checkout(
                rnd.slot_key(g[0] if len(g) == 1 else None, name),
                sum(m[2] for m in members) * esize)
            dst = lease.tensor.view(dtype)
            if n > 1:
                dst.copy_(flat, non_blocking=cuda)
            else:
                for i, off, m in members:
                    grad = self.tensors[i].grad
                    if grad is None:
                        dst[off: off + m].zero_()
                    else:
                        dst[off: off + m].copy_(grad.reshape(-1),
                                                non_blocking=cuda)
            staged.append((name, members, lease, dtype, None, None, sparse))
        if cuda and staged:
            torch.cuda.current_stream(state.device).synchronize()
        ready = []
        for i in streamed:
            fut, lease = rnd.futures[i]
            wire = torch.float32 if self._registry is not None \
                else self.tensors[i].dtype
            ready.append(([(i, 0, self.tensors[i].numel())],
                          None if fut is None else fut.result(), lease,
                          i if i in rnd.shards else None, wire))
        for name, members, lease, dtype, shard, parent, sparse in staged:
            handle = None
            if lease is not None and sparse:
                shape = self.tensors[members[0][0]].shape
                handle, nbytes = _submit_rowsparse(
                    state, name, lease.array(np.float32).reshape(shape),
                    out=lease.array(np.float32))
                rnd.pushed(nbytes)
                rnd.handles.append(handle)
                self.counters["rowsparse_bytes"] += nbytes
            elif lease is not None:
                handle = self._submit(rnd, name,
                                      lease.array(_np_dtype(dtype)),
                                      production=shard is not None,
                                      parent=parent)
            ready.append((members, handle, lease, shard, dtype))
        return ready

    def _drain(self, state, rnd: _Export, ready: list, leaf_apply,
               cuda: bool) -> List:
        """Land every aggregate in completion order and run each leaf's
        optimizer step; returns the copy events that the next step waits
        for before reusing the slots. One process copies each aggregate
        from its slot into ``p.grad``. In a dp group the root takes its
        keys in completion order and broadcasts each one's index (and -1
        when the rest stay carried), so every rank lands the same key
        next: a whole-leaf key or bucket is copied
        to the card on the root and broadcast from it; a leaf of the shard
        plan is landed shard by shard, each rank its own, and all-gathered.
        Every rank then steps the leaf, so the parameters stay the same on
        every rank."""
        dev, group, n = state.device, state.group, rnd.n_dp
        root = state.is_root
        compute = torch.cuda.current_stream(dev) if cuda else None
        if n > 1:
            if cuda:
                # the hooks' means and copies, and the reduces that the
                # root's broadcast overwrites, come before any write to
                # p.grad
                compute.wait_stream(self._stream("d2h", dev))
            for w in rnd.works:
                w.wait()
            idx = torch.zeros(1, dtype=torch.int64, device=dev if
                              dist.get_backend(group) == "nccl" else "cpu")
        done: "queue.Queue" = queue.Queue()
        if root:
            for wi, (_, handle, _, _, _) in enumerate(ready):
                handle.add_done_callback(
                    lambda wi=wi: done.put((wi, time.perf_counter())))
        # cross-barrier: the step releases once every other key has
        # landed; a carry-eligible one lands too if its reply is already
        # in, and is carried to the next step otherwise
        carry_wi = {wi for wi, (members, _, _, shard, _) in enumerate(ready)
                    if len(members) == 1 and shard is None
                    and members[0][0] in rnd.carry}
        pending = set(range(len(ready)))
        events, last_done = [], rnd.t_backward_end
        h2d_ms = apply_ms = 0.0
        prof, hc = rnd.prof, rnd.hc
        h2d_hist = state.metrics.histogram("step/h2d_update_us")
        ag_hist = state.metrics.histogram("step/allgather_us")
        while pending:
            if root:
                wi = -1     # the rest are carried
                if pending - carry_wi or not done.empty():
                    t_wait = time.perf_counter()
                    wi, t_done = done.get()
                    last_done = max(last_done, t_done)
                    if prof is not None:
                        # the drain blocked on a pull: the PULL signal
                        prof.add_pull_wait(time.perf_counter() - t_wait)
            if n > 1:
                # the root's decision, so every rank lands and carries
                # the same keys
                if root:
                    idx.fill_(wi)
                dist.broadcast(idx, src=0, group=group)
                wi = int(idx.item())
            if wi < 0:
                break
            pending.discard(wi)
            members, handle, lease, shard, wire = ready[wi]
            if handle is not None:
                state.handles.wait_and_clear(handle.id)   # raises its error
            t0 = time.perf_counter()
            buf = None      # one process: each member straight from the slot
            if shard is not None:
                piece = torch.empty(rnd.shards[shard]["slen"], dtype=wire,
                                    device=dev)
                self._h2d(lease.tensor.view(wire), piece, compute, events,
                          fresh=True)
                t_ag = time.perf_counter()
                buf = gather_leaf(piece, self.tensors[shard], group)
                dt = time.perf_counter() - t_ag
                ag_hist.record_seconds(dt)
                if prof is not None:
                    prof.stage_sample("ALLGATHER", dt)
            elif n > 1:
                buf = torch.empty(sum(m[2] for m in members), dtype=wire,
                                  device=dev)
                if root:
                    self._h2d(lease.tensor.view(wire), buf, compute, events,
                              fresh=True)
                dist.broadcast(buf, src=0, group=group)
            for i, off, m in members:
                p = self.tensors[i]
                if hc is not None and lease is not None:
                    # the pulled aggregate in its host slot, before the
                    # copy to the card (JAX taps before device_put)
                    hc.leaf(i, lease.array(_np_dtype(wire))[off: off + m])
                t_leaf = time.perf_counter()
                if p.grad is None:
                    p.grad = torch.empty_like(p)
                if buf is None:
                    self._h2d(lease.tensor.view(wire)[off: off + m],
                              p.grad.view(-1), compute, events)
                else:
                    p.grad.view(-1).copy_(buf.reshape(-1)[off: off + m])
                if self.spans.enabled and cuda:
                    compute.synchronize()
                t1 = time.perf_counter()
                h2d_ms += (t1 - t0) * 1e3
                if leaf_apply is not None:
                    leaf_apply.step(p)
                    if self.spans.enabled and cuda:
                        compute.synchronize()
                t0 = time.perf_counter()
                apply_ms += (t0 - t1) * 1e3
                # one leaf's copy to the card and its optimizer step
                h2d_hist.record_seconds(t0 - t_leaf)
                if prof is not None:
                    prof.stage_sample("H2D_UPDATE", t0 - t_leaf)
        if pending:
            # these slots stay leased until the next step drains them
            entries = [(ready[wi][0][0][0], *ready[wi][1:3], ready[wi][4])
                       for wi in sorted(pending)]
            self._carry = {"entries": entries, "step": self._xb_seq}
            kept = {id(e[2]) for e in entries}
            with rnd._mu:
                rnd.leases = [lz for lz in rnd.leases if id(lz) not in kept]
        self.last_completion = last_done
        if root:
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

    def _h2d(self, src: torch.Tensor, dst: torch.Tensor, compute,
             events: List, fresh: bool = False) -> None:
        """Copy host ``src`` into device ``dst`` on the copy stream and make
        the compute stream wait for it (a plain copy on the CPU). A
        ``fresh`` ``dst``, just allocated on the compute stream, is
        written only after the compute stream's work so far; a gradient's
        last writer, the backward, has finished, and its last reader, a
        carried leaf's optimizer step, is ordered by ``_apply_carry``."""
        if compute is None:
            dst.copy_(src)
            return
        h2d = self._stream("h2d", dst.device)
        if fresh:
            h2d.wait_stream(compute)
        with torch.cuda.stream(h2d):
            dst.copy_(src, non_blocking=True)
        dst.record_stream(h2d)
        ev = torch.cuda.Event()
        ev.record(h2d)
        compute.wait_event(ev)
        events.append(ev)

    def _abandon(self, state, rnd: _Export) -> None:
        """Error path: let the export worker finish what it started, then
        drop the step's handles and never recycle its slots (a reply may
        still be written into them)."""
        for fut, _ in list(rnd.futures.values()):
            if fut is None:
                continue
            try:
                fut.result(timeout=120)
            except Exception:  # noqa: BLE001 - the step's error is raised
                pass
        for h in rnd.handles:
            state.handles.discard(h.id)
        for lease in rnd.leases:
            lease.abandon()
        # a raised step voids the carry: its rounds' slots are abandoned
        self._void_carry(state, self._carry)
        self._carry = None


def on_card(dev: torch.device):
    """``dev`` the calling thread's current CUDA device for a block (no-op
    on the CPU). A step may run on any Python thread, and one that never
    set its device is on card 0: there a stream context's exit puts the
    thread back on card 0, which makes a context on card 0 in the
    process of a rank on another card."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _declare(state, name: str, n: int, dtype: torch.dtype,
             align: Optional[int] = None):
    """Declare and partition a key before, or instead of, pushing it, as
    the rank that pushes it does (``get_or_init_ctx``, or with the row
    alignment ``align`` a row-sparse key): the registry of every rank of
    a dp group then numbers every key alike, and a later key (a shard
    plan's) gets one number on every rank. Returns its context."""
    from ..core.types import DataType
    return state.registry.init_tensor(
        name, n * torch.empty((), dtype=dtype).element_size(),
        DataType.of_torch(dtype), align_bytes=align)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype
