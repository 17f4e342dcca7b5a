"""Process state of the port: the device and the ``dp`` process group.

The JAX package builds a device mesh whose ``dp`` axis spans the local
chips (parallel/mesh.py, core/state.py). Here one process drives one card,
and the ``dp`` axis is a ``torch.distributed`` group over the processes of
the host: NCCL on the card, gloo on the CPU. The rendezvous is loopback
only (``tcp://127.0.0.1:<BYTEPS_COORD_PORT>``), a store the caller
passes (such as a ``FileStore`` in a test's temporary directory), or, for
a group of one, an in-memory store.

Topology comes from the BytePS variables ``BYTEPS_LOCAL_RANK`` and
``BYTEPS_LOCAL_SIZE`` (default 0 and 1). A default group that exists
when ``init`` runs (``parallel/distributed.py`` ``ensure_initialized``)
is the job's one group: ``init`` takes it, with its rank and size, and
``shutdown`` leaves it to its maker.

PS mode (byteps_tpu/core/state.py:410-424): with ``DMLC_NUM_SERVER`` > 0
and the worker role, ``init`` also connects the parameter-server client
and builds the tensor registry, the host staging arena, the pipeline
scheduler and the handle table that ``training.make_ps_train_step``
reads. The ``dp`` group stays: it is the intra-node reduce before the
PS round, as NCCL is in BytePS. The group is one PS worker: every rank
connects under the machine's worker id (``server.client.ps_worker_id``),
because on the locality-shard export each rank pushes its own shard
keys; whole-leaf keys are pushed by the local root alone, and only the
root sends SHUTDOWN, after a barrier of the group. The scheduler gets the
registry, whose routing its failover migrates, and the wire knobs
(BYTEPS_FUSED_PUSHPULL, BYTEPS_WIRE_RETRY, BYTEPS_WIRE_BACKOFF_MS); the
flight recorder (``core/flight.py``) is armed afresh for each ``init``.

The measurement plane (byteps_tpu/core/state.py:200-305), fresh for each
``init``: the push_pull byte rate (``Telemetry``), the metrics registry
(``core/metrics.py``) with its ``arena``, ``server``, ``fleet``,
``flight``, ``ledger``, ``timeseries`` and ``steps`` sections, the flight
recorder and its server collector (FLIGHT_DRAIN with each server's clock
offset), the efficiency ledger, the time-series plane and the SIGTERM
chain (time series, perf archive, flight dump), the training-health
plane, the ``barrier/*`` counters, the step profiler with its observers
in the JAX order (health, ledger, time series), and with
BYTEPS_METRICS_PORT the ``/metrics`` endpoint. The PS client counts the
wire on the registry and the scheduler feeds it and the profiler. The
``fleet`` section reads each server over STATS_PULL (``source``
``wire``), else the servers of this process (``local``); a sweep that
takes too long drops the wire path for the lifecycle, as in JAX.
BYTEPS_STAGING_ARENA=0 makes the arena hand out fresh buffers.

Elastic suspend and resume (byteps_tpu/core/state.py:690-741):
``suspend`` stops the scheduler and closes the client without stopping
the servers, and keeps the registry's declarations, the handle table
and the ``dp`` group; ``resume(num_workers, num_servers, global_rank)``
writes the new topology into the environment (checking
BYTEPS_SERVER_HOSTS first), connects a new client and scheduler, and
re-partitions every declaration in order against the new server count
(``registry.redeclare_all``), so the keys stay every worker's. A round
still queued or in flight at the suspend fails, and its handle raises.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from datetime import timedelta
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..config import Config
from ..utils.logging import log, refresh_level
from .metrics import MetricsRegistry, StepProfiler


def resolve_device(device: Union[None, str, torch.device] = None,
                   local_rank: Optional[int] = None) -> torch.device:
    """The device an entry point runs on: the caller's, else
    ``cuda:<local_rank>``. Without a card, only an explicit CPU device is
    accepted: nothing runs on the CPU unless asked."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    if local_rank is None:
        st = get_state()
        local_rank = st.local_rank if st.initialized else \
            int(os.environ.get("BYTEPS_LOCAL_RANK", "0") or 0)
    return torch.device("cuda", local_rank)


class Telemetry:
    """The push_pull byte rate (global.cc:697-752,
    byteps_tpu/core/state.py:29-136): bytes of finished push_pulls in
    windows of about ten seconds, read as MB/s by ``get_pushpull_speed``
    (when BYTEPS_TELEMETRY_ON), every byte also on the registry's
    ``pushpull/bytes_total``; and the streamed export's counters, which
    ``get_arena_stats`` shows beside the arena's."""

    WINDOW_SEC = 10.0

    def __init__(self, enabled: bool = True, metrics=None) -> None:
        self.enabled = enabled
        self._arena = None
        self._lock = threading.Lock()
        self._window_start = time.monotonic()   # guarded-by: _lock
        self._window_bytes = 0                  # guarded-by: _lock
        self._last_sample = (0.0, 0.0)          # guarded-by: _lock
        self._export = {"export_streamed_leaves": 0,
                        "export_fallback_leaves": 0, "export_rounds": 0,
                        "export_shard_leaves": 0,
                        "export_ttfp_ms": None}  # guarded-by: _lock
        self._wire_counter = None if metrics is None else \
            metrics.counter("pushpull/bytes_total")

    def record(self, nbytes: int) -> None:
        if self._wire_counter is not None:
            self._wire_counter.inc(int(nbytes))
        if not self.enabled:
            return
        with self._lock:
            now = time.monotonic()
            self._window_bytes += nbytes
            elapsed = now - self._window_start
            if elapsed >= self.WINDOW_SEC:
                self._last_sample = (now, self._window_bytes / elapsed / 1e6)
                self._window_start = now
                self._window_bytes = 0

    def speed(self) -> tuple:
        with self._lock:
            return self._last_sample

    def attach_arena(self, arena) -> None:
        self._arena = arena

    def record_export(self, streamed: int, fallback: int,
                      ttfp_s: Optional[float],
                      shard_leaves: int = 0) -> None:
        """One PS step's export: the leaves the backward's hooks streamed
        and those exported after it, and the time to first push."""
        with self._lock:
            e = self._export
            e["export_streamed_leaves"] += int(streamed)
            e["export_fallback_leaves"] += int(fallback)
            e["export_rounds"] += 1
            e["export_shard_leaves"] += int(shard_leaves)
            if ttfp_s is not None:
                e["export_ttfp_ms"] = ttfp_s * 1e3

    def arena_stats(self) -> dict:
        """The arena's counters and the export's."""
        from .arena import StagingArena
        arena = self._arena if self._arena is not None else \
            StagingArena(enabled=False)
        stats = arena.stats()
        with self._lock:
            stats.update(self._export)
        return stats


class GlobalState:
    """The singleton behind ``byteps_tpu_torch.init``/``shutdown``."""

    _instance: Optional["GlobalState"] = None
    _cls_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self.initialized = False
        self.config = Config()
        self.device: Optional[torch.device] = None
        self.group = None            # the dp process group
        self._owns_group = True      # made by init, destroyed by shutdown
        self.local_rank = 0
        self.local_size = 1
        # PS mode (num_servers > 0, worker role); None otherwise
        self.ps_client = None
        self.registry = None
        self.arena = None
        self.scheduler = None
        # the int handles of the asynchronous ops, in every mode; a
        # suspend keeps them, so a handle from before it raises its error
        # and its id is never handed out again
        self.handles = None
        self._version: Dict[str, int] = {}
        # between suspend() and resume()
        self.suspended = False
        # the measurement plane, made afresh by each init
        self.telemetry = Telemetry()
        self.metrics = MetricsRegistry()
        self.profiler = StepProfiler()
        self.flight = None
        self.ledger = None
        self.timeseries = None
        self.health = None
        self._metrics_server = None
        # one-way breakers of the fleet sweeps, fresh for each init
        self._fleet_probe_tripped = False
        self._fleet_section_tripped = False

    @classmethod
    def get(cls) -> "GlobalState":
        with cls._cls_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def init(self, device=None, store: Optional[dist.Store] = None,
             rank: Optional[int] = None,
             world_size: Optional[int] = None,
             backend: Optional[str] = None) -> None:
        with self._lock:
            if self.suspended:
                raise RuntimeError("init() while suspended: call resume(), "
                                   "or shutdown() first")
            if self.initialized:
                log.warning("init() called while already initialized; "
                            "call shutdown() first to re-initialize")
                return
            refresh_level()
            self.config = Config.from_env()
            env = os.environ
            # a default group made before (parallel/distributed.py
            # ensure_initialized) is the job's one group: take it
            self._owns_group = not dist.is_initialized()
            if not self._owns_group:
                rank, world_size = dist.get_rank(), dist.get_world_size()
            self.local_rank = rank if rank is not None else \
                int(env.get("BYTEPS_LOCAL_RANK", "0") or 0)
            self.local_size = world_size if world_size is not None else \
                int(env.get("BYTEPS_LOCAL_SIZE", "1") or 1)
            # the PS worker id derives from these, so they must be the
            # group's own and not a second read of the environment
            self.config = dataclasses.replace(
                self.config, local_rank=self.local_rank,
                local_size=self.local_size)
            self.device = resolve_device(device, self.local_rank)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            if backend is None:
                backend = "nccl" if self.device.type == "cuda" else "gloo"
            kw = dict(backend=backend, rank=self.local_rank,
                      world_size=self.local_size,
                      timeout=timedelta(seconds=300))
            if backend == "nccl":
                # the group's card: its collectives and barrier use it,
                # whichever thread calls them and whatever that thread's
                # current device is
                kw["device_id"] = self.device
            if store is None and self.local_size == 1:
                store = dist.HashStore()   # one process: no socket
            if store is not None:
                kw["store"] = store
            elif self._owns_group:
                port = env.get("BYTEPS_COORD_PORT", "")
                if not port:
                    raise RuntimeError(
                        "BYTEPS_LOCAL_SIZE > 1 needs BYTEPS_COORD_PORT "
                        "for the loopback rendezvous")
                kw["init_method"] = f"tcp://127.0.0.1:{port}"
            if self._owns_group:
                dist.init_process_group(**kw)
            self.group = dist.group.WORLD
            self._init_planes()
            from .scheduler import HandleManager
            self.handles = HandleManager()
            try:
                self._init_ps()
            except BaseException:
                self._stop_ps()
                self.registry = None
                if self._owns_group:
                    dist.destroy_process_group()
                raise
            self._start_metrics_server()
            self.initialized = True
            log.info("init: rank %d/%d on %s (%s)%s", self.local_rank,
                     self.local_size, self.device, backend,
                     f", PS client of {self.config.num_servers} server(s)"
                     if self.ps_client is not None else "")

    def _init_planes(self) -> None:
        """The measurement plane, fresh for this init, in the order of
        byteps_tpu/core/state.py:200-305."""
        cfg = self.config
        from . import flight as flight_mod
        from .health import HealthPlane, register_health_metrics
        from .ledger import EfficiencyLedger, register_ledger_metrics
        from .timeseries import TimeSeriesPlane
        from ..server import stage_section
        self.metrics = MetricsRegistry(enabled=cfg.metrics_on)
        self.telemetry = Telemetry(cfg.telemetry_on, self.metrics)
        self.metrics.section("arena", self.telemetry.arena_stats)
        self.metrics.section("server", stage_section)
        self.metrics.section("fleet", self._fleet_section)
        self._fleet_probe_tripped = False
        self._fleet_section_tripped = False
        self.flight = flight_mod.configure(
            capacity=cfg.flight_ring, enabled=cfg.flight_recorder,
            dump_dir=cfg.flight_dir)
        self.metrics.section("flight", self.flight.snapshot)
        flight_mod.set_server_collector(self._collect_server_flight)
        register_ledger_metrics(self.metrics)
        self.ledger = EfficiencyLedger(cfg, self.metrics, device=self.device)
        self.metrics.section("ledger", self.ledger.snapshot)
        self.timeseries = TimeSeriesPlane(
            points=cfg.ts_points, enabled=cfg.timeseries and cfg.metrics_on,
            registry=self.metrics, dump_dir=cfg.flight_dir)
        self.metrics.section("timeseries", self.timeseries.snapshot)
        if (cfg.flight_recorder or self.ledger.archive_enabled
                or self.timeseries.enabled):
            flight_mod.install_signal_handler()
        if self.timeseries.enabled:
            flight_mod.add_term_hook(self.timeseries.term_dump,
                                     order=flight_mod.TERM_ORDER_TIMESERIES)
        if self.ledger.archive_enabled:
            flight_mod.add_term_hook(self.ledger.term_flush)
        register_health_metrics(self.metrics)
        self.health = HealthPlane(cfg, self.metrics)
        # the carry's counters: zeros on a step without cross-barrier
        self.metrics.counter("barrier/carried_leaves")
        self.metrics.counter("barrier/carry_drained")
        self.profiler = StepProfiler(
            window=cfg.step_report_window, enabled=cfg.metrics_on,
            stall_diag=cfg.stall_diag, fleet_probe=self._fleet_stage_probe,
            ledger=self.ledger)
        self.metrics.section("steps", self.profiler.snapshot)
        # the health plane first (it stamps health_flags), the ledger
        # next (it prices and archives), the time series last
        if self.health.enabled:
            self.profiler.add_observer(self.health.on_step)
        if self.ledger.enabled:
            self.profiler.add_observer(self.ledger.on_step)
        if self.timeseries.enabled:
            self.profiler.add_observer(self.timeseries.observe)

    def _start_metrics_server(self) -> None:
        port = self.config.metrics_port
        if port <= 0 or self._metrics_server is not None:
            return
        from .metrics import start_http_server
        try:
            self._metrics_server = start_http_server(
                lambda: self.metrics, port)
            log.info("metrics endpoint on 127.0.0.1:%d/metrics", port)
        except Exception as e:  # noqa: BLE001 - the endpoint is an extra
            log.warning("metrics HTTP server failed to start: %s", e)

    def _stop_planes(self) -> None:
        """Shutdown's half of the plane: the endpoint stops, the perf
        archive flushes its tail and the time series dump theirs."""
        if self._metrics_server is not None:
            try:
                self._metrics_server.shutdown()
                self._metrics_server.server_close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
            self._metrics_server = None
        if self.ledger is not None:
            try:
                self.ledger.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass
        if self.timeseries is not None:
            try:
                self.timeseries.dump_jsonl(reason="shutdown",
                                           lock_timeout=1.0)
            except Exception:  # noqa: BLE001 - best-effort teardown
                pass

    # ---- the fleet (byteps_tpu/core/state.py:463-684) ----------------- #

    def _fleet_section(self) -> dict:
        """The ``fleet`` section: one derived stats dict per reachable
        server, by index, over STATS_PULL (``source`` "wire"), else from
        the servers of this process ("local"). Each pull waits at most
        1 s, and a sweep over 2.5 s drops the wire path for the
        lifecycle, with one log line."""
        from ..server import derive_stage_section, per_server_stats
        servers: dict = {}
        source = "none"
        client = None if self._fleet_section_tripped else self.ps_client
        if client is not None:
            t0 = time.monotonic()
            for s in range(len(client.servers)):
                try:
                    raw = client.server_stats(s, timeout_s=1)
                except Exception:  # noqa: BLE001 - a dead server: skip
                    raw = None
                if raw is not None:
                    servers[str(s)] = derive_stage_section(raw)
            elapsed = time.monotonic() - t0
            if elapsed > 2.5:
                self._fleet_section_tripped = True
                log.warning("fleet snapshot sweep took %.1fs — dropping "
                            "the wire path for this lifecycle (in-process "
                            "mirror only)", elapsed)
            if servers:
                source = "wire"
        if not servers:
            for i, raw in enumerate(per_server_stats()):
                servers[str(i)] = derive_stage_section(raw)
            if servers:
                source = "local"
        return {"workers": max(1, self.config.num_workers),
                "servers": len(servers), "source": source,
                "server": servers}

    def _fleet_stage_probe(self):
        """The profiler's per-step server attribution: the fleet's
        cumulative per-stage ns, from the servers of this process (a
        ctypes read), else over STATS_PULL, whose first sweep over
        250 ms turns the probe off for the lifecycle; None when no
        server answers."""
        from ..server import stage_stats
        keys = ("recv_ns", "queue_ns", "fold_ns", "reply_ns")
        raw = stage_stats()
        if raw.get("live"):
            return {k: raw[k] for k in keys}
        client = self.ps_client
        if self._fleet_probe_tripped or client is None:
            return None
        t0 = time.monotonic()
        tot = dict.fromkeys(keys, 0)
        seen = False
        for s in range(len(client.servers)):
            try:
                st = client.server_stats(s, timeout_s=1)
            except Exception:  # noqa: BLE001 - a dead server: skip
                st = None
            if st is None:
                continue
            seen = True
            for k in keys:
                tot[k] += st[k]
        elapsed = time.monotonic() - t0
        if elapsed > 0.25:
            self._fleet_probe_tripped = True
            log.warning("fleet stage probe took %.0fms — disabling "
                        "per-step server attribution for this lifecycle",
                        elapsed * 1e3)
        return tot if seen else None

    def _collect_server_flight(self) -> list:
        """``flight.dump``'s collector: each server's flight ring over
        FLIGHT_DRAIN with its clock offset (``{server, offset_ns,
        err_ns, events}``); a server that does not answer adds
        nothing."""
        client = self.ps_client
        if client is None:
            return []
        out = []
        for s in range(len(client.servers)):
            try:
                probe = client.clock_probe(s, probes=4, timeout_s=2)
                recs = client.drain_flight(s, timeout_s=2)
            except Exception:  # noqa: BLE001 - a dead server: skip
                continue
            if not recs:
                continue
            off, err = probe if probe is not None else (0, 0)
            out.append({"server": s, "offset_ns": off, "err_ns": err,
                        "events": recs})
        return out

    def _ps_mode(self) -> bool:
        return self.config.num_servers > 0 and self.config.role == "worker"

    def _init_ps(self) -> None:
        """Connect the PS client and build what rides on it. A registry
        kept by ``suspend`` re-partitions its declarations against the
        new topology instead of starting empty."""
        cfg = self.config
        if not self._ps_mode():
            return
        from ..server.client import connect_from_config
        from .arena import StagingArena
        from .registry import TensorRegistry
        from .scheduler import PipelineScheduler
        self.arena = StagingArena(pin=self.device.type == "cuda",
                                  enabled=cfg.staging_arena)
        self.telemetry.attach_arena(self.arena)
        if self.registry is None:
            self.registry = TensorRegistry(cfg)
            self._version = {}
        else:
            self.registry.redeclare_all(cfg)
        self.registry.attach_arena(self.arena)
        self.ps_client = connect_from_config(cfg)
        self.ps_client.attach_metrics(self.metrics)
        self.scheduler = PipelineScheduler(
            self.ps_client, credit_bytes=cfg.scheduling_credit,
            arena=self.arena, registry=self.registry, config=cfg,
            metrics=self.metrics, profiler=self.profiler,
            telemetry=self.telemetry)

    @property
    def is_root(self) -> bool:
        """The local root: the rank that pushes whole-leaf keys and
        sends the PS SHUTDOWN."""
        return self.local_rank == 0

    def _stop_ps(self, shutdown_servers: bool = True) -> None:
        """Stop the scheduler and close the client (the root's SHUTDOWN
        to the servers with ``shutdown_servers``); the registry stays."""
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.ps_client is not None:
            self.ps_client.close(
                shutdown_servers=shutdown_servers and self.is_root)
        if self.arena is not None:
            self.arena.reset()
        self.ps_client = self.scheduler = self.arena = None

    def suspend(self) -> None:
        """Elastic suspend (operations.cc:114-119): stop the scheduler,
        close the client and leave the servers running; the declarations,
        the handle table and the ``dp`` group stay for ``resume``."""
        with self._lock:
            if not self.initialized:
                raise RuntimeError("suspend() before init()")
            self._stop_ps(shutdown_servers=False)
            self.initialized = False
            self.suspended = True

    def resume(self, num_workers: int, num_servers: int,
               global_rank: Optional[int] = None) -> None:
        """Elastic resume with a new topology (common/__init__.py:75-81,
        byteps_tpu/core/state.py:712-741). An explicit BYTEPS_SERVER_HOSTS
        must name at least ``num_servers`` servers, checked before any
        variable changes (a refused resume leaves the environment as it
        was), and is cut to the first ``num_servers`` when shrinking; grow
        a live fleet with ``add_server`` instead. Then DMLC_NUM_WORKER,
        DMLC_NUM_SERVER and BYTEPS_GLOBAL_RANK are set, a new client and
        scheduler connect, and every declaration is re-partitioned in
        order (BYTEPS_RETIRED_SERVERS, exported by ``core/elastic.py``,
        stays retired)."""
        with self._lock:
            if not self.suspended:
                raise RuntimeError("resume() without a suspend()")
            env = os.environ
            hosts = env.get("BYTEPS_SERVER_HOSTS", "")
            addrs = [h.strip() for h in hosts.split(",") if h.strip()]
            if hosts and num_servers > 0 and len(addrs) < num_servers:
                raise ValueError(
                    f"resume(num_servers={num_servers}) but "
                    f"BYTEPS_SERVER_HOSTS names only {len(addrs)} "
                    f"server(s) — set the full host list before resuming, "
                    f"or join live servers with add_server()")
            env["DMLC_NUM_WORKER"] = str(num_workers)
            env["DMLC_NUM_SERVER"] = str(num_servers)
            if hosts and num_servers > 0 and len(addrs) > num_servers:
                env["BYTEPS_SERVER_HOSTS"] = ",".join(addrs[:num_servers])
            if global_rank is not None:
                env["BYTEPS_GLOBAL_RANK"] = str(global_rank)
            refresh_level()
            self.config = dataclasses.replace(
                Config.from_env(), local_rank=self.local_rank,
                local_size=self.local_size)
            self._init_planes()
            try:
                self._init_ps()
            except BaseException:
                self._stop_ps(shutdown_servers=False)
                raise
            self.initialized = True
            self.suspended = False
            log.info("resume: %d worker(s), PS client of %d server(s)",
                     num_workers, num_servers)

    def rank(self) -> int:
        """The global rank (byteps_tpu/core/state.py:759-767):
        BYTEPS_GLOBAL_RANK if set, else worker_id * local_size +
        local_rank."""
        c = self.config
        if c.global_rank is not None:
            return c.global_rank
        return c.worker_id * c.local_size + c.local_rank

    def size(self) -> int:
        """The number of processes of the job: num_workers * local_size."""
        c = self.config
        return max(1, c.num_workers) * max(1, c.local_size)

    def next_version(self, name: str) -> int:
        """Per-tensor submission counter (the reference's version)."""
        with self._lock:
            v = self._version.get(name, 0)
            self._version[name] = v + 1
            return v

    def shutdown(self) -> None:
        with self._lock:
            if not (self.initialized or self.suspended):
                return
            if self.ps_client is not None and self.local_size > 1:
                # every rank's rounds are done before the root's SHUTDOWN
                dist.barrier(group=self.group)
            self._stop_ps()
            self._stop_planes()
            if dist.is_initialized() and self._owns_group:
                dist.destroy_process_group()
            self.group = self.handles = self.registry = None
            self.initialized = self.suspended = False

    def require(self) -> "GlobalState":
        if not self.initialized:
            raise RuntimeError("byteps_tpu_torch is not initialized: call "
                               "byteps_tpu_torch.init() first")
        return self


def get_state() -> GlobalState:
    return GlobalState.get()
