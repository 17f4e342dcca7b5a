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
from datetime import timedelta
from typing import Dict, Optional, Union

import torch
import torch.distributed as dist

from ..config import Config
from ..utils.logging import log, refresh_level


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
            self.initialized = True
            log.info("init: rank %d/%d on %s (%s)%s", self.local_rank,
                     self.local_size, self.device, backend,
                     f", PS client of {self.config.num_servers} server(s)"
                     if self.ps_client is not None else "")

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
        from . import flight
        from .arena import StagingArena
        from .registry import TensorRegistry
        from .scheduler import PipelineScheduler
        self.arena = StagingArena(pin=self.device.type == "cuda")
        if self.registry is None:
            self.registry = TensorRegistry(cfg)
            self._version = {}
        else:
            self.registry.redeclare_all(cfg)
        self.registry.attach_arena(self.arena)
        flight.configure()
        self.ps_client = connect_from_config(cfg)
        self.scheduler = PipelineScheduler(
            self.ps_client, credit_bytes=cfg.scheduling_credit,
            arena=self.arena, registry=self.registry, config=cfg)

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
