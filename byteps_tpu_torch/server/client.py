"""Parameter-server worker client.

Port of byteps_tpu/server/client.py (``PSClient``), trimmed to what the
PS train step calls: the init push of a key and its init cache, the
in-band codec install, the fused PUSHPULL with its completion reactor,
the two-op path's asynchronous PUSH and blocking PULL, the per-server
death probe that the scheduler's failover reads, the barrier and close;
the elastic fleet's control ops (``add_server`` grows the connection
table at run time, ``join_probe`` and ``drain_req`` over the server's
JOIN_PROBE and DRAIN_REQ, byteps_tpu/server/client.py:458-692); the
measurement plane's (``server_stats`` over STATS_PULL, ``drain_flight``
over FLIGHT_DRAIN, ``health_pull`` over HEALTH_PULL and the clock probe
that aligns a server's events with the worker's,
byteps_tpu/server/client.py:462-600) and the ``wire/*`` instruments
that ``attach_metrics`` hangs on the registry (:295-345); the
asynchronous mode's ``init_weights`` and ``push_delta_pull_weights``
(:1128-1148);
and ``get_or_init_ctx``/``ps_round_trip``, a host tensor's registry entry
and its blocking round trip, ``rowsparse_submit``, the one row-sparse
submission, and ``build_rowsparse_payload``, the one producer of the
row-sparse push wire. The JAX client's blocking row-sparse round without
the scheduler is not ported: a PS-mode ``init`` always starts it.
The transport is the native client of ``native/ps.cc`` (the same source
as the JAX package's), so a worker of either package speaks one wire.

``zpushpull_async`` sends one message per aggregation round trip (the
THC shape); a single completion-reactor thread drains the native
completion queue and resolves each request's callback, so in-flight
requests are not bounded by threads.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import struct
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..core.types import (
    DataType, Partition, RequestType, TensorContext, get_command_type,
)
from ..native.build import build_ps
from ..utils.logging import log

# Python mirror of the native wire header (native/ps.cc MsgHeader): magic,
# op, flags, sender, rid, key, cmd, len, epoch, codec; little-endian,
# packed. The transport is native; these name the contract for tests and
# tooling, and must equal the JAX client's.
WIRE_MAGIC = 0xB17E5003
WIRE_HEADER_FMT = "<IBBHIQIIQI"
WIRE_HEADER_BYTES = 40
assert struct.calcsize(WIRE_HEADER_FMT) == WIRE_HEADER_BYTES

# observability control ops (native/ps.cc enum Op), answered inline by
# the server's connection loop
WIRE_CTRL_OPS = {
    "STATS_PULL": 12,
    "TRACE_DRAIN": 13,
    "FLIGHT_DRAIN": 14,
    "CLOCK_PROBE": 15,
    "JOIN_PROBE": 16,
    "DRAIN_REQ": 17,
    "HEALTH_PULL": 18,
    "STRIPE_PULL": 19,
}

# control-pull reply size limits (native/ps.cc enum CtrlLimits)
WIRE_CTRL_LIMITS = {
    "kCtrlDrainBatch": 1024,
    "kCtrlFlightDrainMax": 4096,
    "kCtrlStripeMax": 64,
}


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_ps())
    vp, i32, u32, u64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                         ctypes.c_uint64)
    lib.bps_client_create.restype = vp
    lib.bps_client_create.argtypes = [ctypes.c_char_p, i32]
    lib.bps_client_init_key.restype = i32
    lib.bps_client_init_key.argtypes = [vp, i32, u64, vp, u32, u32]
    # the two-op path: a push carries the (round << 16 | attempt) epoch
    # stamp and the codec tag; a pull returns the reply's length
    lib.bps_client_push_async.restype = i32
    lib.bps_client_push_async.argtypes = [vp, i32, u64, vp, u32, u32, u64,
                                          u32]
    lib.bps_client_pull.restype = i32
    lib.bps_client_pull.argtypes = [vp, i32, u64, vp, u32, u32]
    lib.bps_client_server_dead.restype = i32
    lib.bps_client_server_dead.argtypes = [vp, i32]
    # fused op: data, cmd, reply buffer, ticket, epoch stamp, codec tag,
    # and the wire rid reported back
    lib.bps_client_pushpull_async2.restype = i32
    lib.bps_client_pushpull_async2.argtypes = [
        vp, i32, u64, vp, u32, u32, vp, u32, u64, u64, u32,
        ctypes.POINTER(u32)]
    lib.bps_client_cq_poll.restype = i32
    lib.bps_client_cq_poll.argtypes = [
        vp, ctypes.POINTER(u64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(u32), i32, i32]
    lib.bps_client_cq_abort.restype = None
    lib.bps_client_cq_abort.argtypes = [vp]
    lib.bps_client_comp_init.restype = i32
    lib.bps_client_comp_init.argtypes = [vp, i32, u64, ctypes.c_char_p]
    # a control pull (JOIN_PROBE, DRAIN_REQ, STATS_PULL, FLIGHT_DRAIN):
    # server, op, reply buffer, its capacity and a timeout in seconds;
    # returns the reply's length. The keyed one (HEALTH_PULL) names a key
    lib.bps_client_ctrl.restype = i32
    lib.bps_client_ctrl.argtypes = [vp, i32, i32, vp, u32, i32]
    lib.bps_client_ctrl_key.restype = i32
    lib.bps_client_ctrl_key.argtypes = [vp, i32, i32, u64, vp, u32, i32]
    # four steady-clock stamps (client send, server recv, server send,
    # client recv) of one CLOCK_PROBE echo
    lib.bps_client_clock_probe.restype = i32
    lib.bps_client_clock_probe.argtypes = [vp, i32, ctypes.POINTER(u64),
                                           i32]
    lib.bps_client_cq_depth.restype = i32
    lib.bps_client_cq_depth.argtypes = [vp]
    # a server connected at run time: returns its index
    lib.bps_client_add_server.restype = i32
    lib.bps_client_add_server.argtypes = [vp, ctypes.c_char_p]
    lib.bps_client_barrier.restype = i32
    lib.bps_client_barrier.argtypes = [vp]
    lib.bps_client_shutdown.restype = i32
    lib.bps_client_shutdown.argtypes = [vp]
    lib.bps_client_destroy.restype = None
    lib.bps_client_destroy.argtypes = [vp]
    return lib


def _run_into(fut: concurrent.futures.Future, fn, *args) -> None:
    try:
        fut.set_result(fn(*args))
    except BaseException as e:  # noqa: BLE001 - the waiter raises it
        fut.set_exception(e)


def server_addresses(config: Config) -> List[str]:
    """Server endpoints: BYTEPS_SERVER_HOSTS="h:p,h:p,..." or the
    scheduler URI with consecutive ports (root_port + server_id); one per
    server index of the registry."""
    hosts = os.environ.get("BYTEPS_SERVER_HOSTS", "")
    if hosts:
        addrs = [h.strip() for h in hosts.split(",") if h.strip()]
        if len(addrs) != config.num_servers:
            raise ValueError(
                f"BYTEPS_SERVER_HOSTS has {len(addrs)} entries but "
                f"DMLC_NUM_SERVER={config.num_servers}")
        return addrs
    return [f"{config.scheduler_uri}:{config.scheduler_port + i}"
            for i in range(config.num_servers)]


def get_or_init_ctx(state, name: str, host: np.ndarray,
                    dtype: Optional[DataType] = None) -> TensorContext:
    """The registry entry of a flat host tensor: ``init_tensor`` every
    time, which is idempotent for an unchanged size and re-partitions on a
    resize. ``dtype``: the wire dtype where the array's own does not say
    it (BFLOAT16 bits in a uint16 array)."""
    return state.registry.init_tensor(
        name, host.nbytes, dtype or DataType.from_np(host.dtype))


def build_rowsparse_payload(p: Partition, nz: np.ndarray,
                            host2d: np.ndarray) -> np.ndarray:
    """One partition's row-sparse push payload, ``[u32 nrows][u32 width]
    [i32 local ids][f32 rows]`` (byteps_tpu/server/client.py:216-240;
    parsed by ps.cc's DoPushSparse): the rows of ``nz`` (the tensor's
    nonzero row ids, ascending) that fall in the partition, with ids
    relative to its first row. Raises if the partition does not lie on
    row boundaries."""
    width = host2d.shape[1]
    row_bytes = width * 4
    if p.offset % row_bytes or p.length % row_bytes:
        raise ValueError(
            f"partition {p.index} not row-aligned; declare with "
            f"init_tensor(..., align_bytes={row_bytes})")
    lo = p.offset // row_bytes
    hi = (p.offset + p.length) // row_bytes
    sel = nz[(nz >= lo) & (nz < hi)]
    payload = b"".join((
        np.uint32(len(sel)).tobytes(),
        np.uint32(width).tobytes(),
        (sel - lo).astype(np.int32).tobytes(),
        np.ascontiguousarray(host2d[sel]).tobytes(),
    ))
    return np.frombuffer(payload, np.uint8)


def nonzero_rows(host2d: np.ndarray) -> np.ndarray:
    """The ids (int32, ascending) of the rows of ``host2d`` that hold a
    nonzero."""
    return np.flatnonzero(np.any(host2d != 0, axis=1)).astype(np.int32)


def rowsparse_submit(state, name: str, host2d: np.ndarray, average: bool,
                     handle, out: Optional[np.ndarray] = None) -> int:
    """The one row-sparse submission (byteps_tpu/__init__.py:269-284),
    shared by ``push_pull_rowsparse_async``, the adapter and the PS train
    step: declare ``name`` with partitions on whole rows, then enqueue the
    sparse push and dense pull. Returns the bytes of the push payloads."""
    host2d = np.ascontiguousarray(host2d, np.float32)
    ctx = state.registry.init_tensor(name, host2d.nbytes, DataType.FLOAT32,
                                     align_bytes=host2d.shape[1] * 4)
    return state.scheduler.submit_rowsparse(
        ctx, host2d, handle, average, state.config.num_workers,
        version=state.next_version(name), out=out)


def ps_round_trip(state, name: str, host: np.ndarray, average: bool,
                  priority: Optional[int] = None,
                  out: Optional[np.ndarray] = None,
                  dtype: Optional[DataType] = None) -> np.ndarray:
    """The blocking round trip of one flat host tensor through the
    priority-scheduled pipeline: the cross-worker sum (mean when
    ``average``). ``out``: the result buffer (an arena slot), used if it
    fits; ``dtype``: as ``get_or_init_ctx``'s. The JAX package's fallback
    without a scheduler (a blocking two-op PUSH and PULL) is not ported:
    a PS-mode ``init`` always starts the scheduler."""
    if state.scheduler is None:
        raise RuntimeError("ps_round_trip needs the PS scheduler: call "
                           "init() with DMLC_NUM_SERVER > 0")
    host = np.ascontiguousarray(host)
    ctx = get_or_init_ctx(state, name, host, dtype)
    handle = state.handles.allocate(name)
    state.scheduler.submit(ctx, host, handle, average,
                           state.config.num_workers,
                           version=state.next_version(name),
                           priority=priority, out=out)
    return state.handles.wait_and_clear(handle.id)


class PSClient:
    """Thread-safe PS client: one native connection group per server,
    requests multiplexed by id."""

    # the native library has the fused PUSHPULL op: the scheduler takes
    # the fused WIRE stage unless BYTEPS_FUSED_PUSHPULL turns it off
    supports_fused = True

    def __init__(self, servers: Sequence[str], worker_id: int,
                 num_threads: int = 8):
        self._lib = _load_lib()
        self._handle = self._lib.bps_client_create(
            ",".join(servers).encode(), worker_id)
        if not self._handle:
            raise RuntimeError(
                f"failed to connect to PS servers {servers!r}")
        # server addresses by index; add_server appends
        self._servers = list(servers)  # guarded-by: _lock
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=num_threads, thread_name_prefix="bps-init")
        self._closed = False
        self._lock = threading.Lock()
        # key -> store length this client has init-pushed on the server
        self._inited_keys: dict = {}   # guarded-by: _lock
        # key -> (length, future) of an init push started by init_async
        self._init_futs: dict = {}     # guarded-by: _lock
        # fused completion reactor: ticket -> (callback, reply buffer).
        # The buffer ref keeps the memory the native recv loop writes
        # through alive until the ticket completes.
        self._fused_mu = threading.Lock()
        self._fused: dict = {}         # guarded-by: _fused_mu
        self._next_ticket = 1          # guarded-by: _fused_mu
        self._reactor: Optional[threading.Thread] = None
        self._reactor_started = False  # guarded-by: _lock
        # the wire instruments (core/metrics.py), hung on by
        # attach_metrics; None: not counted (a client made alone)
        self._m_push_req = self._m_push_bytes = None
        self._m_pull_req = self._m_pull_bytes = None
        self._m_pushpull_req = self._m_errors = None
        self._m_inflight = self._m_inflight_peak = self._m_cq_depth = None
        # outstanding wire requests (fused requests and blocking pulls)
        self._inflight = 0             # guarded-by: _lock
        self._inflight_peak = 0        # guarded-by: _lock

    def attach_metrics(self, metrics) -> None:
        """Count the wire on the registry (byteps_tpu/server/client.py
        :319-345): ``wire/push_requests`` and ``wire/pull_requests`` (the
        two-op path's), ``wire/pushpull_requests`` (one a partition and
        round on the fused path), ``wire/push_bytes`` (every payload
        sent), ``wire/pull_bytes`` (every reply's length), ``wire/errors``
        (failed requests), and the gauges ``wire/inflight``,
        ``wire/inflight_peak`` and ``wire/cq_depth`` (the completion
        queue's backlog). Init pushes and control pulls are not
        counted."""
        self._m_push_req = metrics.counter("wire/push_requests")
        self._m_push_bytes = metrics.counter("wire/push_bytes")
        self._m_pull_req = metrics.counter("wire/pull_requests")
        self._m_pull_bytes = metrics.counter("wire/pull_bytes")
        self._m_pushpull_req = metrics.counter("wire/pushpull_requests")
        self._m_errors = metrics.counter("wire/errors")
        self._m_inflight = metrics.gauge("wire/inflight")
        self._m_inflight_peak = metrics.gauge("wire/inflight_peak")
        self._m_cq_depth = metrics.gauge("wire/cq_depth")

    def _inflight_add(self, d: int) -> None:
        # the gauge is set under the lock, so two threads' sets land in
        # the count's order
        with self._lock:
            self._inflight += d
            cur = self._inflight
            if cur > self._inflight_peak:
                self._inflight_peak = cur
            if self._m_inflight is not None:
                self._m_inflight.set(cur)
                self._m_inflight_peak.set_max(cur)

    def _error(self) -> None:
        if self._m_errors is not None:
            self._m_errors.inc()

    def _num_servers(self) -> int:
        with self._lock:
            return len(self._servers)

    def _check_server(self, server: int) -> None:
        # the native connection table is indexed unchecked
        n = self._num_servers()
        if not 0 <= server < n:
            raise ValueError(f"server index {server} out of range "
                             f"[0, {n})")

    # ---- the elastic fleet's control ops ------------------------------ #

    @property
    def servers(self) -> List[str]:
        """The server addresses, by index (``add_server`` appends)."""
        with self._lock:
            return list(self._servers)

    def _ctrl(self, server: int, op: str, cap: int,
              timeout_s: int = 5) -> Optional[bytes]:
        """One control pull with its own timeout (a wedged server costs
        ``timeout_s``, not the data plane's); the reply, or None when the
        request failed."""
        self._check_server(server)
        if self._closed:
            raise RuntimeError("control pull on a closed PSClient")
        buf = (ctypes.c_uint8 * cap)()
        n = self._lib.bps_client_ctrl(self._handle, server,
                                      WIRE_CTRL_OPS[op], buf, cap, timeout_s)
        return None if n < 0 else bytes(buf[:n])

    def add_server(self, address: str) -> int:
        """Connect a server started at run time and return its index, the
        earlier server count (the native side publishes its connections
        at once, so traffic to the others never sees a half-built table).
        ``join_probe`` it before any key routes there."""
        if self._closed:
            raise RuntimeError("add_server on a closed PSClient")
        idx = self._lib.bps_client_add_server(self._handle, address.encode())
        if idx < 0:
            raise RuntimeError(
                f"failed to connect new PS server at {address!r}")
        with self._lock:
            while len(self._servers) <= idx:
                self._servers.append(address)
            self._servers[idx] = address
        log.info("PS client: joined server %d at %s", idx, address)
        return idx

    def join_probe(self, server: int, timeout_s: int = 5) -> Optional[dict]:
        """The join handshake (JOIN_PROBE): ``{"num_workers",
        "draining"}`` of ``server``, or None where it does not answer."""
        raw = self._ctrl(server, "JOIN_PROBE", 16, timeout_s)
        if raw is None or len(raw) != 16:
            return None
        nw, draining = struct.unpack("<QQ", raw)
        return {"num_workers": int(nw), "draining": bool(draining)}

    def drain_req(self, server: int, timeout_s: int = 5) -> Optional[dict]:
        """The drain's acknowledgement (DRAIN_REQ): the server latches its
        draining flag and answers ``{"keys_held", "draining"}``, or None.
        Asked after the keys have moved; it gates nothing."""
        raw = self._ctrl(server, "DRAIN_REQ", 16, timeout_s)
        if raw is None or len(raw) != 16:
            return None
        held, draining = struct.unpack("<QQ", raw)
        return {"keys_held": int(held), "draining": bool(draining)}

    # ---- per-server health (the failover's probe) --------------------- #

    # ---- the measurement plane's control ops -------------------------- #

    def server_stats(self, server: int,
                     timeout_s: int = 5) -> Optional[dict]:
        """One server's stats slots over STATS_PULL (the vector of the
        in-process ``bps_server_stats``); None when it does not answer."""
        raw = self._ctrl(server, "STATS_PULL", 64 * 8, timeout_s)
        if raw is None or len(raw) % 8:
            return None
        from . import parse_stat_slots
        return parse_stat_slots(raw)

    def drain_flight(self, server: int, timeout_s: int = 5) -> List[dict]:
        """A snapshot of the server's flight-recorder ring over
        FLIGHT_DRAIN (it leaves the ring as it is, so a poll never takes
        the events a later dump needs); each kind by its name."""
        from . import (
            FLIGHT_KIND_NAMES, FLIGHT_REC_BYTES, FLIGHT_REC_FMT,
            _FLIGHT_REC_FIELDS,
        )
        raw = self._ctrl(
            server, "FLIGHT_DRAIN",
            WIRE_CTRL_LIMITS["kCtrlFlightDrainMax"] * FLIGHT_REC_BYTES,
            timeout_s)
        if not raw or len(raw) % FLIGHT_REC_BYTES:
            return []
        out = []
        for rec in struct.iter_unpack(FLIGHT_REC_FMT, raw):
            d = dict(zip(_FLIGHT_REC_FIELDS, rec))
            d.pop("pad", None)
            d["kind"] = FLIGHT_KIND_NAMES.get(d["kind"], str(d["kind"]))
            out.append(d)
        return out

    def health_pull(self, server: int, key: int,
                    timeout_s: int = 5) -> Optional[dict]:
        """The post-aggregation statistics of ``key``'s last published
        round over HEALTH_PULL (``{key, round, sumsq, absmax, nonfinite,
        elems}``, the server's in-fold pass under BYTEPS_HEALTH); None
        when the server has no such key or runs with the pass off."""
        self._check_server(server)
        if self._closed:
            raise RuntimeError("control pull on a closed PSClient")
        from . import HEALTH_REC_BYTES, parse_health_rec
        buf = (ctypes.c_uint8 * HEALTH_REC_BYTES)()
        n = self._lib.bps_client_ctrl_key(
            self._handle, server, WIRE_CTRL_OPS["HEALTH_PULL"], int(key),
            buf, HEALTH_REC_BYTES, timeout_s)
        if n != HEALTH_REC_BYTES:
            return None
        return parse_health_rec(bytes(buf))

    def clock_probe(self, server: int, probes: int = 8,
                    timeout_s: int = 5) -> Optional[tuple]:
        """``(offset_ns, err_ns)`` of the server's steady clock against
        this process's, from the least-delayed of ``probes`` CLOCK_PROBE
        echoes (``server clock - offset`` is this process's clock); None
        when no echo came back."""
        self._check_server(server)
        if self._closed:
            return None
        buf = (ctypes.c_uint64 * 4)()
        samples = []
        for _ in range(max(1, probes)):
            if self._lib.bps_client_clock_probe(
                    self._handle, server, buf, timeout_s) != 0:
                continue
            samples.append(tuple(int(buf[i]) for i in range(4)))
        if not samples:
            return None
        from ..core.flight import estimate_clock_offset
        try:
            return estimate_clock_offset(samples)
        except ValueError:
            return None

    def server_dead(self, server: int) -> bool:
        """True when every native connection to ``server`` is dead (the
        TCP EOF of a crashed or killed server, seen by the recv loops
        within milliseconds), or the client is closed; the scheduler then
        migrates that server's keys (byteps_tpu/server/client.py:601)."""
        if self._closed or not 0 <= server < self._num_servers():
            return True
        return bool(self._lib.bps_client_server_dead(self._handle, server))

    def dead_servers(self) -> List[int]:
        return [s for s in range(self._num_servers())
                if self.server_dead(s)]

    def invalidate_init(self, keys) -> None:
        """Forget that ``keys`` were init-pushed: a migrated key has no
        store on its adoptive server yet, so the next ``ensure_init``
        pushes its init there."""
        with self._lock:
            for k in keys:
                self._inited_keys.pop(k, None)
                self._init_futs.pop(k, None)

    def init_key(self, server: int, key: int, data: np.ndarray,
                 cmd: int) -> None:
        """Blocking init push of one key: allocates the server store and
        is the per-key barrier across workers."""
        self._check_server(server)
        buf = np.ascontiguousarray(data)
        rc = self._lib.bps_client_init_key(
            self._handle, server, key, buf.ctypes.data, buf.nbytes, cmd)
        if rc != 0:
            raise RuntimeError(f"init_key failed key={key}")

    def ensure_init(self, ctx: TensorContext, nbytes: int) -> None:
        """Init-push (zeros) every partition of ``ctx`` this client has
        not initialized at its current length."""
        total = sum(p.length for p in ctx.partitions)
        if nbytes != total:
            raise ValueError(
                f"ensure_init: caller nbytes={nbytes} != partitioned "
                f"total {total} for {ctx.name!r}")
        with self._lock:
            missing = [p for p in ctx.partitions
                       if self._inited_keys.get(p.key) != p.length]
            started = {p.key: self._init_futs.get(p.key) for p in missing}
        if not missing:
            return
        cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, ctx.dtype)
        futures = []
        for p in missing:
            f = started[p.key]
            if f is None or f[0] != p.length:
                f = (p.length, self._pool.submit(
                    self.init_key, p.server, p.key,
                    np.zeros(p.length, np.uint8), cmd))
            futures.append(f[1])
        for f in futures:
            f.result()
        with self._lock:
            self._inited_keys.update({p.key: p.length for p in missing})
            for p in missing:
                self._init_futs.pop(p.key, None)

    def init_async(self, ctx: TensorContext) -> None:
        """Start the init push of every partition of ``ctx`` not yet
        initialized, each on a thread of its own, and return;
        ``ensure_init`` waits for them. A key's init is the server's
        barrier of all workers, so a worker whose exports init keys one
        by one in its own production order would wait forever on a peer
        that inits them in another order (a JAX worker, whose order is
        XLA's); keys started here do not wait on each other."""
        cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, ctx.dtype)
        with self._lock:
            for p in ctx.partitions:
                if self._inited_keys.get(p.key) == p.length or \
                        self._init_futs.get(p.key, (None,))[0] == p.length:
                    continue
                fut: concurrent.futures.Future = concurrent.futures.Future()
                self._init_futs[p.key] = (p.length, fut)
                threading.Thread(
                    target=_run_into, daemon=True, name="bps-init-async",
                    args=(fut, self.init_key, p.server, p.key,
                          np.zeros(p.length, np.uint8), cmd)).start()

    # ---- asynchronous training (BYTEPS_ENABLE_ASYNC) ------------------- #

    def uninited(self, ctx: TensorContext) -> list:
        """The partitions of ``ctx`` this client has not init-pushed at
        their length: all of them on a new client, and those of a key
        that a join or a drain moved (``invalidate_init``)."""
        with self._lock:
            return [p for p in ctx.partitions
                    if self._inited_keys.get(p.key) != p.length]

    def init_weights(self, ctx: TensorContext, flat: np.ndarray) -> None:
        """Seed the async server's weights of ``ctx`` with ``flat``: the
        init push, with its values, of every partition not yet
        init-pushed (the first worker's wins; server.cc:266-295,
        434-436). Blocks until every worker has made its init push, the
        per-key barrier."""
        cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, ctx.dtype)
        view = np.ascontiguousarray(flat).reshape(-1).view(np.uint8)
        missing = self.uninited(ctx)
        futures = [self._pool.submit(self.init_key, p.server, p.key,
                                     view[p.offset:p.offset + p.length], cmd)
                   for p in missing]
        for f in futures:
            f.result()
        with self._lock:
            self._inited_keys.update({p.key: p.length for p in missing})

    def push_delta_pull_weights(self, ctxs: Sequence[TensorContext],
                                deltas: Sequence[np.ndarray]
                                ) -> List[np.ndarray]:
        """Asynchronous data parallelism (server.cc:315-319): push this
        worker's weight delta of each key, which the server adds into its
        weights with no barrier of the workers, and return the weights it
        then holds, one array a key. Every partition of every key goes
        out at once as one fused PUSHPULL, which the server answers after
        the partition's fold, so the reply holds this delta; the call
        waits once for them all."""
        if self._closed:
            raise RuntimeError("push_delta_pull_weights on a closed "
                               "PSClient")
        done = threading.Semaphore(0)
        errors: List[Optional[Exception]] = []

        def on_done(got: int, err, p) -> None:
            if err is None and got != p.length:
                err = RuntimeError(f"weights reply for key={p.key} is "
                                   f"{got} bytes, expected {p.length}")
            errors.append(err)
            done.release()

        outs, sent = [], 0
        for ctx, delta in zip(ctxs, deltas, strict=True):
            delta = np.ascontiguousarray(delta).reshape(-1)
            out = np.empty_like(delta)
            outs.append(out)
            cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, ctx.dtype)
            src, dst = delta.view(np.uint8), out.view(np.uint8)
            for p in ctx.partitions:
                lo, hi = p.offset, p.offset + p.length
                self.zpushpull_async(p.server, p.key, src[lo:hi],
                                     dst[lo:hi], cmd,
                                     lambda g, e, p=p: on_done(g, e, p))
                sent += 1
        for _ in range(sent):
            done.acquire()
        err = next((e for e in errors if e is not None), None)
        if err is not None:
            raise err
        return outs

    def comp_init(self, server: int, key: int, kwargs_wire: str) -> None:
        """Install a server-side codec for ``key`` (the reference's
        in-band kwargs push, operations.cc:396-408)."""
        self._check_server(server)
        rc = self._lib.bps_client_comp_init(
            self._handle, server, key, kwargs_wire.encode())
        if rc != 0:
            raise RuntimeError(
                f"comp_init failed key={key} kwargs={kwargs_wire!r}")

    # ---- the two-op path: PUSH, then a blocking PULL ------------------ #

    def zpush_async(self, server: int, key: int, data: np.ndarray,
                    cmd: int, epoch: int = 0, codec: int = 0) -> None:
        """Send a push and return once it is on the wire (the native send
        copies ``data``); the ACK drains in the background, and a server
        reject or a dead connection surfaces on the paired ``zpull``.
        ``epoch``: the (round << 16 | attempt) replay stamp; ``codec``:
        the adaptive codec tag (0 = none)."""
        self._check_server(server)
        data = np.ascontiguousarray(data)
        rc = self._lib.bps_client_push_async(
            self._handle, server, key, data.ctypes.data, data.nbytes, cmd,
            epoch, codec)
        if self._m_push_req is not None:
            self._m_push_req.inc()
            self._m_push_bytes.inc(data.nbytes)
        if rc != 0:
            self._error()
            raise RuntimeError(f"async push failed key={key}")

    def zpull(self, server: int, key: int, out: np.ndarray, cmd: int,
              exact: bool = False) -> int:
        """Pull the key's aggregate into ``out``, blocking until its round
        completes; returns the reply's length. ``exact``: ``out`` is the
        whole reply (a dense pull), and a shorter reply raises. A reply
        longer than ``out`` always fails."""
        self._check_server(server)
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("zpull requires a C-contiguous output array")
        self._inflight_add(1)
        try:
            rc = self._lib.bps_client_pull(
                self._handle, server, key, out.ctypes.data, out.nbytes, cmd)
        finally:
            self._inflight_add(-1)
        if self._m_pull_req is not None:
            self._m_pull_req.inc()
        if rc < 0:
            self._error()
            raise RuntimeError(
                f"pull failed key={key} (server error, reply larger than "
                f"the {out.nbytes}-byte output, or connection lost)")
        if exact and rc != out.nbytes:
            self._error()
            raise RuntimeError(f"pull reply for key={key} is {rc} bytes, "
                               f"expected exactly {out.nbytes}")
        if self._m_pull_bytes is not None:
            self._m_pull_bytes.inc(rc)
        return rc

    # ---- fused PUSHPULL + completion reactor ------------------------- #

    def zpushpull_async(self, server: int, key: int, data: np.ndarray,
                        out: np.ndarray, cmd: int,
                        on_done: Callable[[int, Optional[Exception]], None],
                        epoch: int = 0, codec: int = 0) -> int:
        """Push ``data``; when the server's aggregation round completes,
        the aggregate lands in ``out`` and ``on_done(reply_len, error)``
        runs on the reactor thread. Returns once the request is on the
        wire, with its wire rid. ``epoch``: (round << 16 | attempt)
        replay stamp; ``codec``: adaptive codec tag (0 = none)."""
        self._check_server(server)
        if not out.flags["C_CONTIGUOUS"]:
            raise ValueError("zpushpull_async requires a C-contiguous "
                             "reply buffer")
        if self._closed:
            raise RuntimeError("zpushpull_async on a closed PSClient")
        data = np.ascontiguousarray(data)
        with self._fused_mu:
            ticket = self._next_ticket
            self._next_ticket += 1
            # registered before the send: the reply can complete first
            self._fused[ticket] = (on_done, out)
        self._ensure_reactor()
        self._inflight_add(1)
        rid = ctypes.c_uint32(0)
        rc = self._lib.bps_client_pushpull_async2(
            self._handle, server, key, data.ctypes.data, data.nbytes, cmd,
            out.ctypes.data, out.nbytes, ticket, epoch, codec,
            ctypes.byref(rid))
        if self._m_pushpull_req is not None:
            self._m_pushpull_req.inc()
            self._m_push_bytes.inc(data.nbytes)
        if rc != 0:
            # the native side still owned the request: exactly one of this
            # raise and the reactor callback fires
            with self._fused_mu:
                owned = self._fused.pop(ticket, None) is not None
            if owned:
                self._inflight_add(-1)
                self._error()
                raise RuntimeError(f"fused pushpull failed to send "
                                   f"key={key} (connection lost)")
        return int(rid.value)

    def _ensure_reactor(self) -> None:
        with self._lock:
            if self._reactor_started:
                return
            self._reactor = threading.Thread(
                target=self._reactor_loop, name="bps-cq-reactor",
                daemon=True)
            self._reactor_started = True
            self._reactor.start()

    def _reactor_loop(self) -> None:
        """Drain the native completion queue in batches and resolve each
        ticket's callback, until the queue is closed."""
        max_n = 128
        tickets = (ctypes.c_uint64 * max_n)()
        statuses = (ctypes.c_int32 * max_n)()
        lens = (ctypes.c_uint32 * max_n)()
        while True:
            n = self._lib.bps_client_cq_poll(
                self._handle, tickets, statuses, lens, max_n, 250)
            if n < 0:
                return  # closed and drained
            if self._m_cq_depth is not None:
                self._m_cq_depth.set(
                    self._lib.bps_client_cq_depth(self._handle))
            for i in range(n):
                with self._fused_mu:
                    entry = self._fused.pop(int(tickets[i]), None)
                if entry is None:
                    continue  # already failed locally, and counted there
                self._inflight_add(-1)
                cb, _out = entry
                status = int(statuses[i])
                err = None
                if status == -2:
                    err = TimeoutError(
                        "fused pushpull timed out waiting for the "
                        "aggregation round (BYTEPS_CLIENT_TIMEOUT_S)")
                elif status != 0:
                    err = RuntimeError(
                        "fused pushpull failed (server error reply, "
                        "oversized reply, or connection lost)")
                elif self._m_pull_bytes is not None:
                    self._m_pull_bytes.inc(int(lens[i]))
                try:
                    cb(int(lens[i]), err)
                except Exception:  # noqa: BLE001 - must not kill the reactor
                    log.exception("fused completion callback raised "
                                  "(ticket %d)", int(tickets[i]))

    def _stop_reactor(self) -> None:
        """Fail outstanding fused requests, close the queue and join the
        reactor, so no callback runs after the handle is freed."""
        with self._lock:
            started = self._reactor_started
        if not started:
            return
        self._lib.bps_client_cq_abort(self._handle)
        self._reactor.join(timeout=10)
        with self._fused_mu:
            leftovers = list(self._fused.items())
            self._fused.clear()
        for ticket, (cb, _out) in leftovers:
            try:
                cb(0, RuntimeError("PSClient closed with the fused request "
                                   "still in flight"))
            except Exception:  # noqa: BLE001
                log.exception("fused teardown callback raised (ticket %d)",
                              ticket)

    def barrier(self) -> None:
        if self._lib.bps_client_barrier(self._handle) != 0:
            raise RuntimeError("barrier failed")

    def close(self, shutdown_servers: bool = True) -> None:
        """Drop the connections; ``shutdown_servers`` also sends SHUTDOWN,
        and a server exits once every worker has."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)
        # an init_async thread still uses the native client
        with self._lock:
            started = [f for _, f in self._init_futs.values()]
        concurrent.futures.wait(started)
        self._stop_reactor()
        if shutdown_servers:
            # a dead server's connections fail at once; the survivors
            # get their SHUTDOWN
            self._lib.bps_client_shutdown(self._handle)
        self._lib.bps_client_destroy(self._handle)


def ps_worker_id(config: Config) -> int:
    """The PS worker id of this process: BYTEPS_GLOBAL_RANK if set, else
    DMLC_WORKER_ID. Every rank of a ``dp`` group takes the machine's id,
    because the group is one PS worker, as one JAX process with every
    local chip in its mesh is: the server sizes its per-worker push
    counts by ``num_workers`` (native/ps.cc:4484), releases a key's init
    barrier after ``num_workers`` inits and exits after ``num_workers``
    SHUTDOWNs. So each key gets one push and one init per machine (from
    the rank that pushes it) and only the local root sends SHUTDOWN."""
    return config.global_rank if config.global_rank is not None \
        else config.worker_id


def connect_from_config(config: Config) -> PSClient:
    servers = server_addresses(config)
    if not servers:
        raise RuntimeError("num_servers > 0 but no server addresses")
    wid = ps_worker_id(config)
    log.info("connecting PS client: servers=%s worker=%d (local rank %d of "
             "%d)", servers, wid, config.local_rank, config.local_size)
    return PSClient(servers, wid)
