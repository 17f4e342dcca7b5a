"""byteps_tpu_torch.torch — BytePS's PyTorch adapter, on the port.

Port of byteps_tpu/torch/__init__.py (BytePS's byteps/torch), so that
``import byteps_tpu_torch.torch as bps`` takes the place of ``import
byteps_tpu.torch as bps``: ``bps.DistributedOptimizer(opt,
named_parameters=model.named_parameters())`` push_pulls every gradient of
any ``nn.Module`` through the parameter servers before the update, over
the port's scheduler and client, with the keys of the JAX package's
adapter (``"grad/"``, ``"ddp_grad/"``, ``"bcast_param/"`` + name,
``"broadcast_object/len"``), so a fleet may mix workers of both.

- ``init``/``shutdown``/``rank``/``size``/``local_rank``/``local_size``;
- ``suspend``/``resume``, the elastic pair: the hooks of a
  ``DistributedOptimizer`` or ``DistributedDataParallel`` made before a
  suspend push to the resumed fleet, and a round started before it
  raises where it is waited for;
- the async ops on the package's int handles: ``push_pull_async``,
  ``poll``, ``synchronize`` (the aggregate written back into the
  tensor), ``push_pull``, ``push_pull_inplace``;
- ``broadcast_parameters`` (the non-root workers push zeros, the sum is
  the root's), ``broadcast_object`` (an int64 length, then the uint8
  payload), ``broadcast_optimizer_state``;
- ``DistributedOptimizer``: a dynamic subclass of the user's optimizer
  whose ``register_post_accumulate_grad_hook`` per parameter starts the
  gradient's round as the backward produces it (every
  ``backward_passes_per_step``-th pass, the mean of the accumulated
  passes), ``Compression.fp16`` on the wire, 2-D ``torch.sparse``
  gradients (``nn.Embedding(sparse=True)``) row-sparse; ``step()``
  writes the aggregates into ``p.grad`` and steps;
- ``DistributedDataParallel`` with ``sync_gradients()``;
- ``cross_barrier.CrossBarrier``: per-parameter updates as the rounds
  land.

On the card the hook does not block the backward: it copies the
gradient into a pinned host buffer on a side stream that waits on the
backward's, and the adapter's export thread waits for that copy and
submits the round; the aggregate lands in the same buffer, and
``synchronize()`` copies it into ``p.grad`` on the card. bfloat16
travels as its bits (BFLOAT16, summed through f32 by the server), with
no f32 round trip.

One process per PS worker (a ``dp`` group of one); a larger group
raises, as the JAX adapter's hooks also submit each gradient straight
from its one process. Without servers and with one worker everything is
the identity (``size() == 1``).
"""

from __future__ import annotations

import concurrent.futures
import pickle
import threading
import weakref
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

import byteps_tpu_torch as _bps
from byteps_tpu_torch.core.scheduler import Handle
from byteps_tpu_torch.core.state import get_state
from byteps_tpu_torch.core.types import DataType, host_array, host_tensor
from byteps_tpu_torch.ops.push_pull import broadcast_pickled
from byteps_tpu_torch.torch.compression import Compression

__all__ = [
    "init", "shutdown", "suspend", "resume", "rank", "size", "local_rank",
    "local_size",
    "push_pull", "push_pull_async", "push_pull_inplace", "poll",
    "synchronize", "DistributedOptimizer", "DistributedDataParallel",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "Compression",
]


def init(device=None, **kwargs) -> None:
    """``byteps_tpu_torch.init``: the card unless ``device="cpu"``."""
    _bps.init(device, **kwargs)


def shutdown() -> None:
    _stop_export()
    _bps.shutdown()


def suspend() -> None:
    """``byteps_tpu_torch.suspend``, after the export thread has handed
    over what it holds: a round started before the suspend then fails
    with the scheduler, and raises where it is waited for."""
    _stop_export()
    _bps.suspend()


def resume(num_workers: int, num_servers: int,
           global_rank: Optional[int] = None) -> None:
    """``byteps_tpu_torch.resume``: the same keys on the new topology."""
    _bps.resume(num_workers, num_servers, global_rank)


def rank() -> int:
    return get_state().require().rank()


def size() -> int:
    return get_state().require().size()


def local_rank() -> int:
    return get_state().require().local_rank


def local_size() -> int:
    return get_state().require().local_size


def _require():
    """The state, which must be initialized with one process per PS
    worker."""
    state = get_state().require()
    if state.local_size > 1:
        raise NotImplementedError(
            "byteps_tpu_torch.torch takes one process per PS worker; a dp "
            "group of more than one (the intra-node reduce under the "
            "adapter) is not ported (ROADMAP.md §A)")
    return state


# --------------------------------------------------------------------- #
# host tensors, handles (torch/ops.py:48-174, handle_manager.cc)
# --------------------------------------------------------------------- #

def _identity(state, host: np.ndarray, name: str,
              wire: DataType) -> Handle:
    """One worker and no servers: the round is the sum over one
    contributor, resolved at once."""
    h = state.handles.allocate(name)
    h.shape, h.wire = host.shape, wire
    h._finish(np.ascontiguousarray(host).reshape(-1).copy(), None)
    return h


def _submit(host: np.ndarray, name: str, average: bool,
            priority: Optional[int] = None,
            dtype: Optional[DataType] = None,
            out: Optional[np.ndarray] = None) -> Handle:
    """Start the round of ``host`` under ``name``
    (``byteps_tpu_torch.push_pull_async``); ``out``: the flat result
    buffer (it may be ``host``'s own memory)."""
    state = _require()
    if state.scheduler is None:
        return _identity(state, host, name,
                         dtype or DataType.from_np(host.dtype))
    return state.handles.get(_bps.push_pull_async(
        host, name, average, priority, out=out, dtype=dtype))


def _submit_rowsparse(host2d: np.ndarray, name: str, average: bool,
                      out: Optional[np.ndarray] = None) -> Handle:
    """Row-sparse round of a [rows, width] gradient: its nonzero rows up,
    the dense aggregate back (``byteps_tpu_torch.push_pull_rowsparse``)."""
    state = _require()
    if state.scheduler is None:
        return _identity(state, np.asarray(host2d, np.float32), name,
                         DataType.FLOAT32)
    return state.handles.get(_bps.push_pull_rowsparse_async(
        host2d, name, average, out=out))


def _wait(h: Handle, timeout: Optional[float] = None) -> torch.Tensor:
    """The aggregate behind ``h`` as a CPU tensor of its input's shape;
    releases the handle."""
    out = get_state().require().handles.wait_and_clear(h.id, timeout)
    return host_tensor(out.reshape(h.shape), h.wire)


# ---- the hooks' export: side-stream copy, then the export thread ------ #

_export_mu = threading.Lock()
_export_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_side_streams: Dict[torch.device, Any] = {}


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _export_pool
    with _export_mu:
        if _export_pool is None:
            _export_pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="bps-adapter-export")
        return _export_pool


def _stop_export() -> None:
    global _export_pool
    with _export_mu:
        pool, _export_pool = _export_pool, None
        _side_streams.clear()
    if pool is not None:
        pool.shutdown(wait=True)


def _side_stream(device: torch.device):
    with _export_mu:
        s = _side_streams.get(device)
        if s is None:
            s = _side_streams[device] = torch.cuda.Stream(device)
        return s


class _Pending:
    """A gradient's round started by a hook: its handle, or on the card
    the export thread's future of it."""

    def __init__(self, handle: Optional[Handle] = None, future=None):
        self._handle = handle
        self._future = future

    def handle(self) -> Handle:
        return self._handle if self._future is None else \
            self._future.result()

    def done(self) -> bool:
        if self._future is not None and not self._future.done():
            return False
        return self.handle().done()

    def wait(self) -> torch.Tensor:
        return _wait(self.handle())


def _submit_staged(buf: torch.Tensor, name: str, average: bool,
                   sparse: bool) -> Handle:
    """Submit the staged ``buf``; the aggregate lands in it too (each
    partition is sent before its reply can land)."""
    host, dtype = host_array(buf)
    if sparse:
        return _submit_rowsparse(host, name, average, out=host.reshape(-1))
    return _submit(host, name, average, None, dtype, out=host.reshape(-1))


def _land(p: torch.Tensor, t: torch.Tensor, compression=None, ctx=None,
          sparse: bool = False) -> None:
    """Write the aggregate ``t`` (a host tensor, the staging buffer's
    memory) into ``p.grad`` on ``p``'s device: copied first (from pinned
    memory, in order on the caller's stream), then decompressed there. A
    sparse gradient is replaced by the dense aggregate."""
    with torch.no_grad():
        t = t.to(p.device, non_blocking=True, copy=True)
        if compression is not None:
            t = compression.decompress(t, ctx)
        if sparse or p.grad.is_sparse:
            p.grad = t.to(p.dtype).reshape(p.shape)
        else:
            p.grad.copy_(t.to(p.grad.dtype).reshape(p.grad.shape))


def _export(t: torch.Tensor, name: str, average: bool,
            staging: Dict[str, torch.Tensor],
            sparse: bool = False) -> _Pending:
    """Start the round of gradient ``t`` under ``name``: copy it into the
    host buffer ``staging[name]`` (pinned on the card, kept across steps:
    a round's input stays untouched until its aggregate is taken) and
    submit it. On the card the copy runs on a side stream that waits on
    the producing stream and the export thread submits once the copy
    landed, so the backward never waits; ``record_stream`` keeps the
    caching allocator off ``t`` until the copy is done."""
    t = t.detach()
    if sparse:
        t = t.to(torch.float32)
    buf = staging.get(name)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = staging[name] = torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=t.is_cuda)
    if not t.is_cuda:
        buf.copy_(t)
        return _Pending(_submit_staged(buf, name, average, sparse))
    from byteps_tpu_torch.training.train import on_card
    side = _side_stream(t.device)
    with on_card(t.device):
        side.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(side):
            buf.copy_(t, non_blocking=True)
        t.record_stream(side)
        ev = torch.cuda.Event()
        ev.record(side)

    def run():
        ev.synchronize()
        return _submit_staged(buf, name, average, sparse)

    return _Pending(future=_pool().submit(run))


# --------------------------------------------------------------------- #
# the Horovod-style ops
# --------------------------------------------------------------------- #

def push_pull_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None,
                    priority: Optional[int] = None) -> int:
    """Start the push_pull of ``tensor`` under ``name`` (required: keys
    must match across workers); returns an int handle.
    ``synchronize(handle)`` writes the aggregate back into ``tensor``
    (torch/ops.cc:54-96) and returns it."""
    if name is None:
        raise ValueError(
            "push_pull_async requires a stable tensor name (keys must "
            "match across workers; operations.cc:420-427)")
    host, dtype = host_array(tensor)
    h = _submit(host, name, average, priority, dtype)
    h.torch_out = tensor
    return h.id


def poll(handle: int) -> bool:
    return _bps.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None
                ) -> torch.Tensor:
    h = get_state().require().handles.get(handle)
    out = _wait(h, timeout)
    target: torch.Tensor = h.torch_out
    with torch.no_grad():
        target.copy_(out.to(target.dtype))
    return target


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None,
              priority: Optional[int] = None) -> torch.Tensor:
    """Synchronous push_pull, as a new tensor."""
    return synchronize(push_pull_async(tensor.clone(), average, name,
                                       priority))


def push_pull_inplace(tensor: torch.Tensor, average: bool = True,
                      name: Optional[str] = None,
                      priority: Optional[int] = None) -> torch.Tensor:
    return synchronize(push_pull_async(tensor, average, name, priority))


# --------------------------------------------------------------------- #
# broadcasts (torch/__init__.py:261-459)
# --------------------------------------------------------------------- #

def _named_tensors(params: Any) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(params, dict):
        return [(k, v) for k, v in sorted(params.items())
                if isinstance(v, torch.Tensor)]
    return [(name, p) for name, p in params]


def broadcast_parameters(params: Any, root_rank: int = 0) -> None:
    """Every worker's tensors become the root worker's, in place: the
    others push zeros and the sum is the root's (torch/__init__.py
    :261-293), under ``"bcast_param/" + name``. ``params``: a
    ``state_dict`` or (name, tensor) pairs."""
    state = get_state().require()
    if state.scheduler is None:
        return      # one worker: already the root's
    _require()
    is_root = state.config.worker_id == root_rank
    handles = []
    for name, t in _named_tensors(params):
        host, dtype = host_array(t)
        if not is_root:
            host = np.zeros_like(host)
        handles.append((_submit(host, "bcast_param/" + name, False, None,
                                dtype), t))
    for h, t in handles:
        out = _wait(h)
        with torch.no_grad():
            t.copy_(out.to(t.dtype))


def _on_host(obj: Any) -> Any:
    """``obj`` with every tensor in it moved to the host, so a pickle
    sent from one card unpickles on any."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_host(v) for v in obj)
    return obj


def broadcast_object(obj: Any, root_rank: int = 0,
                     name: str = "broadcast_object") -> Any:
    """The root worker's copy of a picklable object (torch/__init__.py
    :419-459): two rounds, the pickle's length (int64, under
    ``name + "/len"``), then the payload (uint8, ``name + "/payload"``);
    the others push zeros."""
    state = get_state().require()
    if state.scheduler is None:
        return obj
    _require()
    is_root = state.config.worker_id == root_rank
    payload = pickle.dumps(_on_host(obj)) if is_root else b""
    return broadcast_pickled(
        payload, lambda a, key: _wait(_submit(a, key, False)).numpy(),
        (f"{name}/len", f"{name}/payload"), np.int64)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """The optimizer's state and hyperparameters become the root
    worker's (torch/__init__.py:295-417, through ``broadcast_object``)."""
    optimizer.load_state_dict(broadcast_object(
        optimizer.state_dict(), root_rank, name="broadcast_opt_state"))


# --------------------------------------------------------------------- #
# DistributedOptimizer (torch/__init__.py:37-216)
# --------------------------------------------------------------------- #

def _start_round(grad: torch.Tensor, name: str,
                 staging: Dict[str, torch.Tensor],
                 compression=Compression.none):
    """Start the round of gradient ``grad`` under ``name``: (pending
    round, decompression ctx, sparse). A 2-D sparse gradient is densified
    and sent row-sparse, any other sparse one dense."""
    if grad.is_sparse and grad.dim() == 2:
        return (_export(grad.coalesce().to_dense(), name, True, staging,
                        sparse=True), None, True)
    if grad.is_sparse:
        grad = grad.coalesce().to_dense()
    comp, ctx = compression.compress(grad)
    return _export(comp, name, True, staging), ctx, False


def _remove_hooks(handles) -> None:
    """Take a dropped optimizer's (or DDP wrapper's) gradient hooks off
    the parameters that outlive it."""
    for h in handles:
        h.remove()


class _DistributedOptimizer(torch.optim.Optimizer):
    """The methods mixed into a dynamic subclass of the user's optimizer:
    a post-accumulate-grad hook per parameter starts its round as the
    backward produces the gradient; ``step()`` waits for every round,
    writes the aggregates into ``p.grad`` and runs the user's step."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step=1):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._backward_passes_per_step = backward_passes_per_step
        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [(f"param.{i}", p) for i, p
                     in enumerate(self._all_params())]
        if len(named) != len({n for n, _ in named}):
            raise ValueError("DistributedOptimizer requires unique "
                             "parameter names")
        self._param_name = {p: name for name, p in named}
        self._pending: dict = {}    # param -> (_Pending, ctx, sparse)
        self._passes: dict = {}
        self._staging: dict = {}    # name -> host buffer
        self._hook_refs = []
        # what a gradient's hook does once its passes are in; a
        # CrossBarrier puts its own submit-and-lock here
        self._on_grad = self._queue_round
        if size() > 1 or get_state().scheduler is not None:
            _require()
            self._register_hooks()

    def _all_params(self):
        for group in self.param_groups:
            for p in group["params"]:
                yield p

    def _register_hooks(self):
        for p in self._all_params():
            if p.requires_grad:
                self._hook_refs.append(
                    p.register_post_accumulate_grad_hook(self._make_hook()))
        weakref.finalize(self, _remove_hooks, list(self._hook_refs))

    def _make_hook(self):
        # the hook holds the optimizer weakly: a parameter's hooks live on
        # the autograd side, out of the garbage collector's sight, so a
        # strong reference would keep the optimizer, its model and their
        # gradients alive after the user drops them
        ref = weakref.ref(self)

        def hook(p: torch.Tensor):
            opt = ref()
            if opt is None:
                return
            opt._passes[p] = opt._passes.get(p, 0) + 1
            if opt._passes[p] < opt._backward_passes_per_step:
                return
            opt._passes[p] = 0
            opt._on_grad(p)

        return hook

    def _queue_round(self, p: torch.Tensor) -> None:
        self._pending[p] = self._start(p)

    def _start(self, p: torch.Tensor):
        """Start ``p``'s round on the mean of the passes
        (``_start_round``)."""
        name = "grad/" + self._param_name.get(p, f"param.{id(p)}")
        grad = p.grad
        if self._backward_passes_per_step > 1:
            grad = grad / self._backward_passes_per_step
        return _start_round(grad, name, self._staging, self._compression)

    def synchronize(self) -> None:
        pending, self._pending = self._pending, {}
        for p, (rnd, ctx, sparse) in pending.items():
            _land(p, rnd.wait(), self._compression, ctx, sparse)

    def step(self, closure=None):
        self.synchronize()
        return super(self.__class__, self).step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1):
    """``optimizer`` with its gradients averaged across the workers before
    each step: an instance of the user's optimizer class with the
    distributed hooks mixed in (torch/__init__.py:441-458)."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step)


# --------------------------------------------------------------------- #
# DistributedDataParallel (torch/parallel/distributed.py)
# --------------------------------------------------------------------- #

class DistributedDataParallel(torch.nn.Module):
    """Module wrapper: the parameters become worker 0's at construction,
    each gradient's round starts from its hook, and ``sync_gradients()``
    (before ``optimizer.step()``) writes the aggregates into the
    gradients. An alternative to ``DistributedOptimizer``, not to be
    combined with it: each pushes every gradient
    (parallel/distributed.py:13-287)."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module
        broadcast_parameters(module.state_dict(), root_rank=0)
        self._pending: dict = {}
        self._staging: dict = {}
        self._hook_refs = []
        if size() > 1 or get_state().scheduler is not None:
            for name, p in module.named_parameters():
                if p.requires_grad:
                    self._hook_refs.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook(name)))
            weakref.finalize(self, _remove_hooks, list(self._hook_refs))

    def _make_hook(self, name):
        ref = weakref.ref(self)     # as the optimizer's hooks: weakly

        def hook(p):
            ddp = ref()
            if ddp is not None:
                ddp._pending[p] = _start_round(p.grad, "ddp_grad/" + name,
                                               ddp._staging)

        return hook

    def sync_gradients(self) -> None:
        pending, self._pending = self._pending, {}
        for p, (rnd, ctx, sparse) in pending.items():
            _land(p, rnd.wait(), Compression.none, ctx, sparse)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)
