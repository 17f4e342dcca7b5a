"""byteps_tpu_torch — the PyTorch and CUDA port of byteps_tpu.

It runs the same training steps as the JAX package on an NVIDIA H100:
the Llama model (``models.llama``), a ``DistributedOptimizer`` that
push_pulls gradients, with optional compression (onebit, topk, randomk,
dithering) and error feedback, over the ``dp`` process group
(``training``), flash attention (``ops.flash_attention``), and the
parameter-server step (``training.make_ps_train_step``), whose gradients
travel dense or compressed, on the card or on the host, and are summed by
the C++ server (``server``, ``native/ps.cc``; ``python -m
byteps_tpu_torch.server`` runs one), with bounded wire retry and failover
to the surviving servers. The Pallas kernels of the JAX package are
CUDA kernels here (``csrc/``), built with nvcc at first use.

    import byteps_tpu_torch as bps
    bps.init()                       # cuda:<BYTEPS_LOCAL_RANK>, NCCL group;
                                     # PS client too if DMLC_NUM_SERVER > 0
    out = bps.push_pull(grad)        # mean across the dp group
    bps.shutdown()

In PS mode the Horovod-style asynchronous surface of BytePS pushes host
tensors through the scheduler: ``h = bps.push_pull_async(array, name)``,
``bps.poll(h)``, ``bps.synchronize(h)``, and ``bps.declare_tensor`` fixes
a name's key ahead of time; ``bps.push_pull_rowsparse(grad2d, name)``
sends only the nonzero rows of an embedding-style gradient (its
asynchronous twin ``push_pull_rowsparse_async`` returns a handle). In PS
mode ``push_pull`` and ``broadcast`` also cross the workers through the
servers, and ``rank()``/``size()`` are global. ``byteps_tpu_torch.torch``
is BytePS's PyTorch adapter (``DistributedOptimizer`` hooks,
``DistributedDataParallel``, ``CrossBarrier``).

The PS fleet is elastic (``core/elastic.py``): ``add_server(address)``
joins a server started at run time and moves keys onto it,
``drain_server(index)`` moves a server's keys to the others and retires
it, and ``suspend()``/``resume(num_workers, num_servers)`` reconnect with
another topology and the same keys. With the servers run under
BYTEPS_ENABLE_ASYNC=1, ``training.make_async_ps_train_step`` trains
asynchronously: each worker pushes its weight delta and pulls the
server's weights, with no barrier of the workers.

The measurement plane: ``get_metrics()`` (the registry's counters,
gauges and histograms with its sections), ``get_fleet_metrics()``,
``get_step_reports()`` (each PS step's ``StepReport``; ``core.metrics.
classify_step`` names what it was bound on), ``get_ledger()`` (the cost
model and the card's peak), ``get_timeseries()``, ``get_arena_stats()``,
``get_pushpull_speed()`` and ``dump_flight_record()``; with
BYTEPS_METRICS_PORT set, ``GET 127.0.0.1:<port>/metrics`` serves the
registry as Prometheus text.

The package imports ``torch`` and numpy and nothing of JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
# the subpackage ``byteps_tpu_torch.torch`` (the PyTorch adapter) becomes
# this module's attribute ``torch`` once imported: the real one is _torch
import torch as _torch

from .core.state import get_state
from .core.types import DataType
from .ops.push_pull import broadcast, push_pull

__all__ = ["init", "shutdown", "suspend", "resume", "add_server",
           "drain_server", "rank", "size", "local_rank", "local_size",
           "push_pull", "broadcast", "declare_tensor", "push_pull_async",
           "push_pull_rowsparse", "push_pull_rowsparse_async", "poll",
           "synchronize", "get_pushpull_speed", "get_metrics",
           "get_fleet_metrics", "get_ledger", "get_timeseries",
           "dump_flight_record", "get_step_reports", "get_arena_stats"]


def init(device=None, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None,
         backend: Optional[str] = None) -> None:
    """Set up the device and the ``dp`` group. ``device`` defaults to
    ``cuda:<local_rank>`` and must be given as ``"cpu"`` to run without a
    card. ``store``/``rank``/``world_size`` override the loopback
    rendezvous and the BYTEPS_LOCAL_* topology (tests pass a FileStore).
    ``backend``: the group's ``torch.distributed`` backend, NCCL on the
    card and gloo on the CPU by default (gloo on the card carries
    all_reduce and broadcast, for ranks that share one card)."""
    get_state().init(device, store=store, rank=rank, world_size=world_size,
                     backend=backend)


def shutdown() -> None:
    get_state().shutdown()


def suspend() -> None:
    """Elastic suspend: close the PS client and leave the servers running;
    the declared keys, the handle table and the ``dp`` group stay. A
    round still in flight fails, and its handle raises."""
    get_state().suspend()


def resume(num_workers: int, num_servers: int,
           global_rank: Optional[int] = None) -> None:
    """Elastic resume with a new topology: the declared keys re-partition
    in their order against ``num_servers`` (``core/state.py``)."""
    get_state().resume(num_workers, num_servers, global_rank)


def add_server(address: Optional[str] = None) -> int:
    """Join a server started at run time: connect, the JOIN_PROBE
    handshake, then keys move onto it (``core/elastic.py``). ``address``
    defaults to ``scheduler_uri:scheduler_port + index``. Returns its
    index. Call between steps; every worker of a fleet joins the same
    server at the same step boundary."""
    from .core import elastic
    return elastic.join_server(get_state().require(), address)


def drain_server(server: int) -> list:
    """Move every key of server ``server`` to the others and retire it
    from assignment; returns the moved keys. The server process keeps
    running: stop it at leisure. Call between steps, on every worker."""
    from .core import elastic
    return elastic.drain_server(get_state().require(), server)


def rank() -> int:
    """This process's global rank: BYTEPS_GLOBAL_RANK, else
    ``worker_id * local_size + local_rank``."""
    return get_state().require().rank()


def size() -> int:
    """The job's process count: ``num_workers * local_size``."""
    return get_state().require().size()


def local_rank() -> int:
    return get_state().require().local_rank


def local_size() -> int:
    return get_state().require().local_size


def declare_tensor(name: str, dtype: DataType = DataType.FLOAT32):
    """Declare a tensor name so that its PS key is assigned now, in the
    caller's order (byteps_declare_tensor, operations.cc:420-427)."""
    return get_state().require().registry.declare(name, dtype)


def _require_ps(op: str, tensor):
    state = get_state().require()
    if state.scheduler is None:
        raise RuntimeError(f"{op} requires a connected PS "
                           "(DMLC_NUM_SERVER > 0)")
    if isinstance(tensor, _torch.Tensor) and tensor.device.type != "cpu":
        raise TypeError(f"{op} takes a host tensor, got one on "
                        f"{tensor.device}")
    return state


def push_pull_async(tensor, name: str, average: bool = True,
                    priority: Optional[int] = None, out=None,
                    dtype: Optional[DataType] = None) -> int:
    """Asynchronous PS push_pull of a host tensor (a numpy array or a CPU
    tensor): returns an int handle at once; the partitions flow through
    the priority-scheduled pipeline, and ``synchronize(handle)`` returns
    the cross-worker sum (mean when ``average``) as a numpy array of the
    input's shape. ``priority=None`` follows the key's pinned priority
    (-declared_key, unless the streamed train step pinned its production
    order); an explicit one counts at the key's first submission only.
    ``out``: a flat result buffer that the caller keeps until the handle
    resolves (torch/ops.py:157-174). ``dtype``: the wire dtype where the
    array's own does not say it (BFLOAT16 bits in a uint16 array)."""
    state = _require_ps("push_pull_async", tensor)
    from .server.client import get_or_init_ctx
    host = np.ascontiguousarray(tensor)
    flat = host.reshape(-1)
    ctx = get_or_init_ctx(state, name, flat, dtype)
    handle = state.handles.allocate(name)
    handle.shape = host.shape
    handle.wire = ctx.dtype
    state.scheduler.submit(ctx, flat, handle, average,
                           state.config.num_workers,
                           version=state.next_version(name),
                           priority=priority, out=out)
    return handle.id


def push_pull_rowsparse_async(tensor, name: str, average: bool = True,
                              out=None) -> int:
    """Asynchronous row-sparse PS push_pull (byteps_tpu/__init__.py
    :287-325) of a [rows, width] f32 host gradient whose rows are mostly
    zero, such as an embedding's: only the nonzero rows travel up,
    ``[nrows][width][ids][rows]`` per row-aligned partition, the server
    scatter-adds them (kRowSparsePushPull), and ``synchronize(handle)``
    returns the dense cross-worker sum (mean when ``average``) of the
    input's shape. ``out``: as ``push_pull_async``'s."""
    state = _require_ps("push_pull_rowsparse", tensor)
    from .server.client import rowsparse_submit
    host = np.ascontiguousarray(tensor, dtype=np.float32)
    if host.ndim != 2:
        raise ValueError(f"expected [rows, width], got shape {host.shape}")
    handle = state.handles.allocate(name)
    handle.shape = host.shape
    handle.wire = DataType.FLOAT32
    rowsparse_submit(state, name, host, average, handle, out=out)
    return handle.id


def push_pull_rowsparse(tensor, name: str, average: bool = True):
    """The blocking ``push_pull_rowsparse_async``: the dense aggregate."""
    return synchronize(push_pull_rowsparse_async(tensor, name, average))


def poll(handle: int) -> bool:
    """True once the push_pull behind ``handle`` finished (PollHandle,
    torch/ops.cc:129-135)."""
    return get_state().require().handles.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None):
    """Wait for the push_pull behind ``handle``; returns the reduced
    array (WaitAndClear, torch/__init__.py:160-176)."""
    handles = get_state().require().handles
    h = handles.get(handle)
    out = handles.wait_and_clear(handle, timeout)
    return out.reshape(getattr(h, "shape", out.shape))


# ---- the measurement plane (byteps_tpu/__init__.py:132-258) ----------- #

def get_pushpull_speed() -> tuple:
    """(timestamp, MB/s) of recent push_pull traffic, in windows of
    about ten seconds (operations.cc:131-136, global.cc:697-752)."""
    return get_state().telemetry.speed()


def get_metrics() -> dict:
    """The metrics registry's snapshot (``core/metrics.py``):

    - ``counters``: monotonic totals (``wire/*`` requests and bytes,
      ``compress/bytes_pre``/``_post``, ``scheduler/credit_stalls``,
      ``wire/retries``, ``pushpull/bytes_total``, ``barrier/*``,
      ``health/*``, ``ledger/efficiency_drops``);
    - ``gauges``: last-written values (the queue depth, ``wire/inflight``,
      the ledger's and the health plane's last step);
    - ``histograms``: log2-bucket latencies (per stage and key class,
      admission wait, ``step/h2d_update_us``, ``step/allgather_us``)
      with count, sum, min, max, p50, p95 and p99;
    - sections: ``arena`` (as ``get_arena_stats()``), ``server`` (the
      servers of this process), ``fleet`` (one entry per server),
      ``flight``, ``ledger``, ``timeseries`` and ``steps`` (the last
      StepReport and its diagnosis).

    BYTEPS_METRICS=0 freezes the instruments; the snapshot still comes,
    with zeros."""
    return get_state().metrics.snapshot()


def get_fleet_metrics() -> dict:
    """``get_metrics()`` with its ``fleet`` section: one per-stage stats
    dict per server, by index, over the STATS_PULL control op when the
    client is connected (``fleet.source`` "wire"), else from the servers
    of this process ("local"), else none ("none"). The Prometheus
    endpoint's ``byteps_fleet_*{server="<i>"}`` series read the same
    section."""
    return get_metrics()


def get_ledger() -> dict:
    """The efficiency ledger's snapshot (``core/ledger.py``): the
    registered cost model (``model_flops`` from FlopCounterMode,
    ``ideal_wire_bytes``, ``source``), the card's peak (``peak_flops``,
    ``peak_bw_gbps``, ``peak_source``), ``roofline_frac`` and the perf
    archive's path and counts; ``{"enabled": False}`` before ``init()``.
    Each step's ``mfu``, ``overlap_frac`` and ``wire_efficiency`` are on
    its StepReport (``get_step_reports()``)."""
    state = get_state()
    if state.ledger is None:
        return {"enabled": False}
    return state.ledger.snapshot()


def get_timeseries(prefix: str = "", tail: Optional[int] = None) -> dict:
    """The time-series plane's rings (``core/timeseries.py``): every
    per-step series, ``step/<field>`` of the StepReports,
    ``counter/<name>`` deltas and ``gauge/<name>`` values, as ``{name:
    {"steps": [...], "values": [...]}}``, oldest first, at most
    BYTEPS_TS_POINTS deep; ``prefix`` filters the names and ``tail``
    bounds the points. ``{"enabled": False}`` before ``init()`` or with
    BYTEPS_TIMESERIES=0."""
    state = get_state()
    if state.timeseries is None or not state.timeseries.enabled:
        return {"enabled": False}
    return {"enabled": True,
            "series": state.timeseries.series(prefix=prefix, tail=tail)}


def dump_flight_record(path: Optional[str] = None) -> Optional[str]:
    """Write the merged flight record (the worker's events and every
    reachable server's ring, on the worker's clock) as JSON; returns the
    path, or None when the recorder is off (BYTEPS_FLIGHT_RECORDER=0)
    and no server has events. SIGTERM and a round that fails for good
    dump it too."""
    from .core import flight
    return flight.dump(path=path, reason="api")


def get_step_reports() -> list:
    """The last BYTEPS_STEP_REPORTS ``StepReport``s of the PS steps, as
    dicts, oldest first."""
    return [r.as_dict() for r in get_state().profiler.reports()]


def get_arena_stats() -> dict:
    """The host staging arena's counters (``core/arena.py``: ``enabled``,
    slots live, bytes pinned, allocations avoided, conflicts, fresh
    buffers) and the streamed export's (``export_streamed_leaves``,
    ``export_fallback_leaves``, ``export_ttfp_ms``). Also
    ``get_metrics()["arena"]``."""
    return get_state().telemetry.arena_stats()
