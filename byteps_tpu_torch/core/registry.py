"""Tensor declaration, PS key encoding, partitioning and server
assignment.

Port of byteps_tpu/core/registry.py (``TensorRegistry``), trimmed to what
the PS train step reads. It gives the same keys and partitions as the JAX
registry for the same names and sizes, so workers of both packages meet
on one server:

- declaration -> monotonically increasing ``declared_key`` per tensor
  name (global.cc:412-429);
- PS key = ``declared_key << 16 | partition_index`` (operations.cc:306-311);
- partitions of at most ``partition_bytes``, rounded to a page
  (operations.cc:140-180; global.cc:134-144), or down to whole rows of
  ``align_bytes`` for a row-sparse tensor;
- server choice by the BYTEPS_KEY_HASH_FN hash of the key, or the
  least-loaded server for "mixed" (global.cc:566-677).

- locality shards: ``declare_shards`` splits a leaf into equal subrange
  keys named ``shard_name`` (the JAX names, so a mixed fleet agrees);
  ``free`` retires a key;
- crash migration (``migrate_server``): a dead server's partitions move
  whole (a row-sparse key keeps its row-aligned table) to the
  least-loaded survivors, the same way on every worker, and the dead
  server takes no new key;
- the elastic fleet (byteps_tpu/core/registry.py:87-107, 249-288,
  457-629): ``add_server`` grows the table by one assignable server,
  ``plan_join`` moves the earliest-declared partitions of the most-loaded
  servers onto it up to its fair share, ``plan_drain`` moves every
  partition of a server to the least-loaded survivors (the move engine of
  ``migrate_server``) and retires it, and ``rebalance`` applies such a
  ``RebalancePlan`` only at the routing version it was computed at;
  ``retire_server`` masks a slot that never took a key; ``redeclare_all``
  re-partitions every declaration in order against a resumed topology.
  Retired servers come in from ``Config.retired_servers``. Every plan is
  computed from the declarations and loads alone, so a worker of either
  package with the same declarations computes the same plan.

Under BYTEPS_ENABLE_MIXED_MODE the colocated mixed mode assigns every
key (``_hash_mixed_mode_locked``, byteps_tpu/core/registry.py:402-428,
BytePS global.cc:566-596). Not ported: the codec plane's plan state.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..config import PAGE_SIZE, Config
from ..utils.logging import log
from .types import DataType, Partition, TensorContext

# Partition index fits in the low 16 bits of a key (operations.cc:306-311).
KEY_SHIFT = 16
MAX_PARTITIONS = 1 << KEY_SHIFT


def _hash_naive(s: str) -> int:
    # the reference's Hash_Naive works on the numeric key (global.cc:598-600)
    key = int(s)
    return (((key >> 16) + (key % 65536)) * 9973) & 0xFFFFFFFFFFFFFFFF


def _hash_builtin(s: str) -> int:
    # FNV-1a: Python's str hash is salted per process (global.cc:609-611)
    h = 0x811C9DC5
    for ch in s:
        h ^= ord(ch)
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def _hash_djb2(s: str) -> int:
    h = 5381
    for ch in s:
        h = ((h << 5) + h + ord(ch)) & 0xFFFFFFFF  # global.cc:613-618
    return h


def _hash_sdbm(s: str) -> int:
    h = 0
    for ch in s:
        h = (ord(ch) + (h << 6) + (h << 16) - h) & 0xFFFFFFFF  # :620-626
    return h


_HASH_FNS = {
    "naive": _hash_naive,
    "built_in": _hash_builtin,
    "djb2": _hash_djb2,
    "sdbm": _hash_sdbm,
}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


@dataclasses.dataclass(frozen=True)
class RebalanceMove:
    """One partition's move from server ``src`` to ``dst``."""

    key: int
    src: int
    dst: int
    length: int


@dataclasses.dataclass(frozen=True)
class RebalancePlan:
    """A join's or a drain's routing change, fenced by the routing
    version it was computed at (byteps_tpu/core/registry.py:87); a death
    moves keys through ``migrate_server``, on the same move engine.
    ``retire``: the server leaves the assignable set once the moves apply
    (a drain)."""

    kind: str            # "join" | "drain"
    server: int          # the joining or draining server
    base_version: int
    moves: tuple         # RebalanceMove, in declaration order
    retire: bool = False

    def keys(self) -> List[int]:
        return [m.key for m in self.moves]


class TensorRegistry:
    """Thread-safe name -> TensorContext table with stable key assignment.
    ``_contexts`` keeps declaration order, the order every migration plan
    walks."""

    def __init__(self, config: Config):
        self._config = config
        self._lock = threading.Lock()
        self._contexts: Dict[str, TensorContext] = {}  # guarded-by: _lock
        self._next_key = 0                             # guarded-by: _lock
        # per-server accumulated bytes, for "mixed" (least-loaded)
        # assignment; guarded-by: _lock
        self._server_load: List[int] = [0] * max(1, config.num_servers)
        # staging arena (core/arena.py): re-partitioning a tensor makes
        # its staged slot sizes stale, so the registry drops them
        self._arena = None
        # servers out of every later assignment: dead (migrate_server),
        # drained, or retired unused, and those the config names retired
        # (a resume carries them); the routing fence, bumped by each
        # routing change
        self._dead_servers: Set[int] = set(
            config.retired_servers)                    # guarded-by: _lock
        self._routing_version = 0                      # guarded-by: _lock

    def attach_arena(self, arena) -> None:
        self._arena = arena

    def declare(self, name: str,
                dtype: DataType = DataType.FLOAT32) -> TensorContext:
        """Declare (or fetch) a tensor by name; the first call assigns the
        next declared_key (global.cc:412-429)."""
        with self._lock:
            ctx = self._contexts.get(name)
            if ctx is None:
                ctx = TensorContext(name=name, declared_key=self._next_key,
                                    dtype=dtype)
                self._next_key += 1
                self._contexts[name] = ctx
                log.debug("declared tensor %s -> key %d", name,
                          ctx.declared_key)
            return ctx

    def get(self, name: str) -> Optional[TensorContext]:
        with self._lock:
            return self._contexts.get(name)

    def redeclare_all(self, new_config: Config) -> None:
        """Elastic resume (global.cc:431-436): every declaration in its
        order, re-partitioned and re-assigned against the new topology
        from an empty load table, keeping each row-sparse alignment, so
        the keys stay every worker's. Death verdicts lapse (a restarted
        server may take its index again); the config's retired servers
        stay out. The routing version advances. As in the JAX registry,
        each context stays marked uninitialized, so its next
        ``init_tensor`` partitions it once more, in the order the run
        touches it."""
        with self._lock:
            self._config = new_config
            num = max(1, new_config.num_servers)
            self._server_load = [0] * num
            self._dead_servers = {s for s in new_config.retired_servers
                                  if s < num}
            self._routing_version += 1
            for ctx in self._contexts.values():
                ctx.initialized = False
                # the load table was reset: the old partitions must not
                # be subtracted from it
                ctx.partitions = []
                if ctx.nbytes:
                    self._partition_locked(ctx, ctx.nbytes, ctx.align_bytes)

    def init_tensor(self, name: str, nbytes: int,
                    dtype: Optional[DataType] = None,
                    align_bytes: Optional[int] = None) -> TensorContext:
        """Partition into <= partition_bytes keys and assign each to a
        server (operations.cc:283-414); idempotent for an unchanged size
        and alignment. ``align_bytes``: partition boundaries on multiples
        of it (a row-sparse tensor's rows never straddle two partitions,
        byteps_tpu/core/registry.py:295-325)."""
        ctx = self.declare(name, dtype or DataType.FLOAT32)
        if dtype is not None:
            ctx.dtype = dtype
        with self._lock:
            if (ctx.initialized and ctx.nbytes == nbytes
                    and ctx.align_bytes == align_bytes):
                return ctx
            self._partition_locked(ctx, nbytes, align_bytes)
            ctx.align_bytes = align_bytes
            ctx.initialized = True
            return ctx

    def _partition_locked(self, ctx: TensorContext, nbytes: int,
                          align_bytes: Optional[int] = None) -> None:
        _check(nbytes > 0, f"tensor {ctx.name} has zero size")
        pb = self._config.partition_bytes
        part_bytes = max(PAGE_SIZE, (pb + PAGE_SIZE - 1) // PAGE_SIZE
                         * PAGE_SIZE)
        if align_bytes:
            _check(nbytes % align_bytes == 0,
                   f"{ctx.name}: size {nbytes} not a multiple of "
                   f"align_bytes {align_bytes}")
            part_bytes = max(align_bytes,
                             part_bytes // align_bytes * align_bytes)
        # re-init: retire the old partitions' load and staged slots (the
        # ":" scopes the match to this tensor's keys)
        if ctx.partitions and self._arena is not None:
            self._arena.invalidate_prefix(ctx.name + ":")
        for p in ctx.partitions:
            if p.server < len(self._server_load):
                self._server_load[p.server] -= p.length
        ctx.nbytes = nbytes
        ctx.partitions = []
        num_parts = (nbytes + part_bytes - 1) // part_bytes
        _check(num_parts <= MAX_PARTITIONS,
               f"{ctx.name}: {num_parts} partitions exceed key space")
        offset = 0
        for i in range(num_parts):
            length = min(part_bytes, nbytes - offset)
            key = (ctx.declared_key << KEY_SHIFT) | i
            server = self._assign_server_locked(key, length)
            ctx.partitions.append(Partition(key=key, index=i, offset=offset,
                                            length=length, server=server))
            offset += length

    def _assign_server_locked(self, key: int, length: int) -> int:
        num_servers = max(1, self._config.num_servers)
        fn_name = self._config.key_hash_fn
        # dead servers are masked out: the hash maps onto the survivors'
        # list (all servers while none died, so healthy assignments do
        # not change); with every server dead the wire fails instead
        alive = [s for s in range(num_servers)
                 if s not in self._dead_servers] or list(range(num_servers))
        if num_servers == 1:
            server = 0
        elif self._config.enable_mixed_mode:
            # the mode encodes the colocated/dedicated split by index, so
            # it keeps the whole range (a dead server fails at the wire
            # and its keys migrate)
            server = self._hash_mixed_mode_locked(key)
        elif fn_name == "mixed":
            # least-loaded; deterministic across workers, which declare in
            # the same order
            server = min(alive, key=lambda s: self._server_load[s])
        else:
            fn = _HASH_FNS.get(fn_name, _hash_djb2)
            server = alive[fn(str(key)) % len(alive)]
        self._server_load[server] += length
        return server

    def _hash_mixed_mode_locked(self, key: int) -> int:
        """The colocated mixed mode (Hash_Mixed_Mode, global.cc:566-596):
        the last ``num_workers`` servers share a host with a worker, and a
        djb2 double hash under ``mixed_mode_bound`` sends a computed share
        of the keys to the dedicated servers, so that a colocated host
        carries less."""
        num_servers = self._config.num_servers
        num_workers = max(1, self._config.num_workers)
        noncolo = num_servers - num_workers
        _check(noncolo >= 1,
               "mixed mode needs num_servers > num_workers (every worker "
               "colocates one server plus dedicated servers)")
        bound = self._config.mixed_mode_bound
        _check(bound >= num_servers,
               f"BYTEPS_MIXED_MODE_BOUND {bound} < num_servers")
        denom = num_workers * (num_workers + noncolo) - 2 * noncolo
        _check(denom > 0,
               "mixed mode requires >= 2 workers (the reference ratio "
               "formula, global.cc:576-584, is undefined at 1 worker: "
               f"workers={num_workers} servers={num_servers})")
        ratio = (2.0 * noncolo * (num_workers - 1)) / denom
        _check(0 <= ratio <= 1,
               "mixed mode requires num_noncolocated <= num_workers")
        h = _hash_djb2(str(key)) % bound
        if h < ratio * bound:
            return _hash_djb2(str(h)) % noncolo
        return noncolo + _hash_djb2(str(h)) % num_workers

    @staticmethod
    def shard_name(name: str, k: int, num_shards: int) -> str:
        """The key name of shard ``k`` of ``num_shards`` of ``name``; part
        of the wire contract (byteps_tpu/core/registry.py:181)."""
        return f"{name}@shard{k}of{num_shards}"

    def declare_shards(self, name: str, shard_nbytes: int, num_shards: int,
                       dtype: Optional[DataType] = None
                       ) -> List[TensorContext]:
        """Declare (and partition) the ``num_shards`` subrange keys of
        ``name``, each of ``shard_nbytes``, in order; idempotent for
        unchanged sizes (byteps_tpu/core/registry.py:188)."""
        _check(num_shards >= 1, f"{name}: num_shards must be >= 1")
        return [self.init_tensor(self.shard_name(name, k, num_shards),
                                 shard_nbytes, dtype)
                for k in range(num_shards)]

    def free(self, name: str) -> bool:
        """Retire a declared tensor: its partitions leave the server load
        table and its staged slots the arena. A later declaration of the
        name takes a new key. False for an unknown name."""
        with self._lock:
            ctx = self._contexts.pop(name, None)
            if ctx is None:
                return False
            if self._arena is not None:
                self._arena.invalidate_prefix(name + ":")
            for p in ctx.partitions:
                if p.server < len(self._server_load):
                    self._server_load[p.server] -= p.length
            return True

    def server_loads(self) -> List[int]:
        with self._lock:
            return list(self._server_load)


    def contexts_in_order(self) -> List[TensorContext]:
        with self._lock:
            return list(self._contexts.values())

    # ---- crash migration (byteps_tpu/core/registry.py:441-530, 631) ---- #

    @property
    def routing_version(self) -> int:
        """Bumped once for each migration that moved keys."""
        with self._lock:
            return self._routing_version

    def dead_servers(self) -> List[int]:
        with self._lock:
            return sorted(self._dead_servers)

    def alive_servers(self) -> List[int]:
        with self._lock:
            return [s for s in range(max(1, self._config.num_servers))
                    if s not in self._dead_servers]

    def _partitions_locked(self) -> Iterator[Tuple[str, Partition]]:
        """(name, partition) in declaration order: the order in which
        every worker computes a plan, so that workers with the same
        declarations get the same plan."""
        for name, ctx in self._contexts.items():
            for p in ctx.partitions:
                yield name, p

    def _moves_off_locked(self, server: int, alive: List[int],
                          keys: Optional[set] = None
                          ) -> List[RebalanceMove]:
        """Each partition of ``server`` (of ``keys`` only, if given) to
        the least-loaded server of ``alive`` at that point; on a copy of
        the load table."""
        loads = list(self._server_load)
        moves: List[RebalanceMove] = []
        for _, p in self._partitions_locked():
            if p.server != server or (keys is not None
                                      and p.key not in keys):
                continue
            dst = min(alive, key=lambda s: loads[s])
            loads[server] -= p.length
            loads[dst] += p.length
            moves.append(RebalanceMove(p.key, server, dst, p.length))
        return moves

    def _apply_moves_locked(self, moves: List[RebalanceMove]) -> List[int]:
        """Re-target each moved ``Partition.server`` in place (a task that
        holds the partition re-routes with it) and move its load."""
        parts = {p.key: p for _, p in self._partitions_locked()}
        for m in moves:
            p = parts.get(m.key)
            if p is None or p.server != m.src:
                raise RuntimeError(
                    f"rebalance plan does not match the routing table: "
                    f"key {m.key} expected on server {m.src}, found "
                    f"{'missing' if p is None else p.server}")
        for m in moves:
            p = parts[m.key]
            self._server_load[m.src] -= p.length
            self._server_load[m.dst] += p.length
            p.server = m.dst
        return [m.key for m in moves]

    # ---- the elastic fleet (byteps_tpu/core/registry.py:457-629) ------ #

    def add_server(self) -> int:
        """Grow the server table by one assignable server with no load (a
        join); ``plan_join`` then moves keys onto it. Returns its
        index."""
        with self._lock:
            idx = self._config.num_servers
            self._config = dataclasses.replace(self._config,
                                               num_servers=idx + 1)
            while len(self._server_load) < idx + 1:
                self._server_load.append(0)
            # a re-used index does not inherit an earlier death verdict
            self._dead_servers.discard(idx)
            return idx

    def retire_server(self, server: int) -> None:
        """Mask ``server`` out of assignment and move nothing: the slot of
        a join that failed after the client connected it (the client's
        table cannot shrink), so that the next join's index aligns."""
        with self._lock:
            self._dead_servers.add(server)

    def plan_join(self, new_server: int) -> RebalancePlan:
        """Move the earliest-declared partitions of the most-loaded other
        server (the lowest index on a tie) onto ``new_server`` until it
        holds at least its fair share (the alive servers' bytes over
        their count). Pure: ``rebalance`` applies it."""
        with self._lock:
            num = max(1, self._config.num_servers)
            _check(0 <= new_server < num, f"plan_join: server {new_server} "
                   f"out of range [0, {num})")
            _check(new_server not in self._dead_servers,
                   f"plan_join: server {new_server} is retired")
            alive = [s for s in range(num) if s not in self._dead_servers]
            loads = list(self._server_load)
            target = sum(loads[s] for s in alive) // max(1, len(alive))
            donors = [s for s in alive if s != new_server]
            moves: List[RebalanceMove] = []
            moved: set = set()
            while donors and loads[new_server] < target:
                donor = max(donors, key=lambda s: (loads[s], -s))
                cand = next((p for _, p in self._partitions_locked()
                             if p.server == donor and p.key not in moved),
                            None)
                if cand is None:
                    break
                moves.append(RebalanceMove(cand.key, donor, new_server,
                                           cand.length))
                moved.add(cand.key)
                loads[donor] -= cand.length
                loads[new_server] += cand.length
            return RebalancePlan("join", new_server, self._routing_version,
                                 tuple(moves))

    def plan_drain(self, server: int) -> RebalancePlan:
        """Every partition of ``server`` to the least-loaded survivor, as
        ``migrate_server`` moves a dead server's, and the server retired.
        Pure: ``rebalance`` applies it. Raises for a retired server and
        for the last survivor."""
        with self._lock:
            num = max(1, self._config.num_servers)
            _check(0 <= server < num, f"plan_drain: server {server} out of "
                   f"range [0, {num})")
            if server in self._dead_servers:
                raise RuntimeError(
                    f"plan_drain: server {server} is already retired")
            alive = [s for s in range(num)
                     if s not in self._dead_servers and s != server]
            if not alive:
                raise RuntimeError(f"cannot drain server {server}: no other "
                                   f"surviving server remains")
            return RebalancePlan("drain", server, self._routing_version,
                                 tuple(self._moves_off_locked(server, alive)),
                                 retire=True)

    def rebalance(self, plan: RebalancePlan) -> List[int]:
        """Apply ``plan`` if the routing table is still at its version (a
        plan computed before another change is refused: recompute it),
        retire a drained server, and advance the version, even with no
        move (the assignable set changed). Returns the moved keys, whose
        init cache the caller drops."""
        with self._lock:
            if plan.base_version != self._routing_version:
                raise RuntimeError(
                    f"stale rebalance plan: computed at routing_version "
                    f"{plan.base_version}, table is now at "
                    f"{self._routing_version} — recompute the plan")
            num = max(1, self._config.num_servers)
            if not 0 <= plan.server < num:
                raise ValueError(f"rebalance plan names server "
                                 f"{plan.server}, out of range [0, {num})")
            moved = self._apply_moves_locked(list(plan.moves))
            if plan.retire:
                self._dead_servers.add(plan.server)
            self._routing_version += 1
            log.info("registry: rebalance kind=%s server=%d moved=%d "
                     "(routing_version=%d)", plan.kind, plan.server,
                     len(moved), self._routing_version)
            return moved

    def migrate_server(self, dead_server: int,
                       keys: Optional[set] = None) -> List[int]:
        """Move every partition of ``dead_server`` (of ``keys`` only, if
        given) to the least-loaded surviving server and keep the dead one
        out of every later assignment. Deterministic across workers: each
        walks the same declarations with the same loads. The adoptive
        server starts each moved key from a new store (the caller
        re-inits it and re-pushes the round). Returns the moved keys, for
        the client's init cache; raises when no server survives."""
        with self._lock:
            self._dead_servers.add(dead_server)
            num = max(1, self._config.num_servers)
            alive = [s for s in range(num) if s not in self._dead_servers]
            if not alive:
                raise RuntimeError(
                    f"server {dead_server} is dead and no surviving "
                    f"server remains ({num} declared, all dead): the PS "
                    f"fleet is gone")
            migrated = self._apply_moves_locked(
                self._moves_off_locked(dead_server, alive, keys))
            if migrated:
                self._routing_version += 1
                log.warning(
                    "registry: migrated %d partition(s) off dead server "
                    "%d (routing_version=%d, survivors=%s)",
                    len(migrated), dead_server, self._routing_version,
                    alive)
            return migrated
