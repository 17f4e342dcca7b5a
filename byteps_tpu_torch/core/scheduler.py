"""Host-side pipeline scheduler of the PS path.

Port of byteps_tpu/core/scheduler.py, trimmed to what the PS train step
uses: dense tensors and host-compressed ones (``submit``, with the
COMPRESS and DECOMPRESS stages around the wire), prebuilt wire
payloads of the device tier (``submit_wire``) and row-sparse pushes with
dense pulls (``submit_rowsparse``), each through the fused
WIRE stage, one PUSHPULL message per partition, or with
BYTEPS_FUSED_PUSHPULL off through the two-op path (a PUSH stage, then a
blocking PULL stage), with the reference's worker-side scheduling
(scheduled_queue.cc, core_loops.cc):

- ``ScheduledQueue``: tasks ordered by (priority desc, key asc), admitted
  while the in-flight byte credit lasts (BYTEPS_SCHEDULING_CREDIT), and
  at most one task of a key in flight, so two rounds of one tensor never
  interleave on the server; under cross-barrier staleness
  (``PipelineScheduler.xb_window``) up to ``window + 1`` successive
  rounds of an uncompressed key, in submission order;
- ``PipelineScheduler``: the dispatcher admits tasks and hands them to
  the WIRE stage; the client's completion reactor finishes them; the
  per-tensor ``TaskGroup`` fires the handle when the last partition
  lands;
- ``HandleManager``: integer handles (torch/handle_manager.cc), with
  done-callbacks that drive the train step's completion-ordered drain.

A wire exchange that fails is retried (``_fail_or_retry``): up to
BYTEPS_WIRE_RETRY times after the first attempt, after a backoff of
BYTEPS_WIRE_BACKOFF_MS doubling per attempt (capped at 2 s). Each task
carries its key's round and its attempt in the epoch stamp, so the
server folds a replayed push once. A retry whose server the client
reports dead first moves that server's keys to the survivors
(``registry.migrate_server``), re-inits them there and re-installs a
host codec's kwargs. When the budget is spent, or no server survives,
the round fails with an error that names the flight record's dump
(``core/flight.py``). The plain int counters ``retries``,
``server_failovers`` and ``key_migrations`` count these events, and so do
the registry's ``wire/retries``, ``wire/server_failovers`` and
``registry/migrations``.

The measurement plane (``core/metrics.py``; byteps_tpu/core/scheduler.py
:52-132, :493-596, :735-770): the queue's depth gauge, admission-wait
histogram and credit stalls; per (stage, key class) latency histograms
(``scheduler/<stage>_us/<class>``, class ``dense``, ``compressed`` or
``wire``); the ``compress/bytes_pre`` and ``compress/bytes_post``
counters, the dense-equivalent and the actual wire bytes of a round
both ways; and the open StepReport's stage samples, queue peak, credit
stalls and wire spans (a PULL sample is one partition's submit to
completion). The compress counters also count the device tier's
compressed payloads (a prebuilt wire with a reply length, under the
compressed command word), which the JAX scheduler leaves out: there the
host stacks alone count. The
push_pull byte rate (``core/state.py`` ``Telemetry``) records each
finished partition's bytes both ways.

Priority is
-declared_key by default (front-of-model tensors win ties,
tensorflow/ops.cc:155-158), or the measured production order of the
streamed export (``production_priority``), pinned per key at its first
submission.

``keys_idle`` is the quiescence that the elastic join and drain
(``core/elastic.py``) wait for. Not yet ported: the codec plane.
"""

from __future__ import annotations

import concurrent.futures
import heapq
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import WIRE_BACKOFF_CAP_MS, Config
from ..utils.logging import log
from . import flight
from .arena import usable_staging
from .types import (
    DataType, Partition, RequestType, TensorContext, get_command_type,
    trunc_divide_inplace,
)

# credit when scheduling is off: effectively unlimited (the reference's
# 32 GB, scheduled_queue.cc:33-45)
UNLIMITED_CREDIT = 32 << 30
# the command words of a compressed payload, whatever its dtype
_COMPRESSED_CMDS = frozenset(
    get_command_type(RequestType.COMPRESSED_PUSH_PULL, dt) for dt in DataType)


class ScheduledQueue:
    """Priority + credit gated task queue (scheduled_queue.cc).

    ``window`` (the staleness credit, byteps_tpu/core/scheduler.py:60-80):
    up to ``window`` more rounds of one key may be in flight while one
    is, for tasks without a host codec stack only: each carries its own
    round stamp, and the server's window gate parks the one that arrives
    ahead (it never sums two rounds). Same-key tasks admit in submission
    order, so round k always goes before round k + 1."""

    def __init__(self, credit_bytes: int = 0, window: int = 0,
                 metrics=None, profiler=None):
        self._credit = (credit_bytes if credit_bytes > 0
                        else UNLIMITED_CREDIT)  # guarded-by: _cv
        self._capacity = self._credit
        self._cv = threading.Condition(threading.Lock())
        self._heap: List = []                  # guarded-by: _cv
        self._counter = itertools.count()
        self._stopped = False                  # guarded-by: _cv
        self._inflight: Dict[int, int] = {}    # guarded-by: _cv
        self._window = max(0, int(window))
        # set by _pop_admissible_locked: the head waits on credit
        self._credit_blocked = False           # guarded-by: _cv
        # the measurement plane's instruments, looked up once
        self._profiler = profiler
        if metrics is not None:
            self._depth_gauge = metrics.gauge("scheduler/queue_depth")
            self._admit_hist = metrics.histogram(
                "scheduler/admission_wait_us")
            self._stall_ctr = metrics.counter("scheduler/credit_stalls")
        else:
            self._depth_gauge = self._admit_hist = self._stall_ctr = None

    def _step(self):
        return self._profiler.current() if self._profiler else None

    def add_task(self, task: "PartitionTask") -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            task.enqueue_t = time.perf_counter()
            # seq keeps same-key tasks in submission order
            heapq.heappush(self._heap, (-task.priority, task.key,
                                        next(self._counter), task))
            depth = len(self._heap)
            self._cv.notify()
        if self._depth_gauge is not None:
            self._depth_gauge.set(depth)
            prof = self._step()
            if prof is not None:
                prof.queue_depth(depth)

    def get_task(self) -> Optional["PartitionTask"]:
        """Block until a task is admitted (credit left, key not in
        flight) or the queue stops."""
        stall_counted = False
        with self._cv:
            while True:
                if self._stopped:
                    return None
                task = self._pop_admissible_locked()
                if task is not None:
                    self._credit -= task.nbytes
                    self._inflight[task.key] = \
                        self._inflight.get(task.key, 0) + 1
                    depth = len(self._heap)
                    break
                if (self._credit_blocked and not stall_counted
                        and self._stall_ctr is not None):
                    # one stall a blocked admission, not one a poll
                    stall_counted = True
                    self._stall_ctr.inc()
                    prof = self._step()
                    if prof is not None:
                        prof.credit_stall()
                self._cv.wait(timeout=0.1)
        if self._admit_hist is not None:
            self._depth_gauge.set(depth)
            self._admit_hist.record_seconds(
                time.perf_counter() - task.enqueue_t)
        return task

    def _pop_admissible_locked(self) -> Optional["PartitionTask"]:
        """Pop the highest-priority admissible task; in-flight keys are
        skipped (beyond the staleness window of an uncompressed task),
        and a credit-starved head blocks admission (no smaller task
        overtakes it, scheduled_queue.cc:136-149)."""
        skipped: List = []
        found = None
        self._credit_blocked = False
        while self._heap:
            item = heapq.heappop(self._heap)
            t = item[3]
            limit = 1 + (self._window if t.stack is None else 0)
            if self._inflight.get(t.key, 0) >= limit:
                skipped.append(item)
                continue
            # a task above the whole capacity runs once credit is full
            if t.nbytes <= self._credit or self._credit >= self._capacity:
                found = t
            else:
                skipped.append(item)
                self._credit_blocked = True
            break
        for item in skipped:
            heapq.heappush(self._heap, item)
        return found

    def report_finish(self, task: "PartitionTask") -> None:
        with self._cv:
            self._credit += task.nbytes
            n = self._inflight.get(task.key, 0) - 1
            if n > 0:
                self._inflight[task.key] = n
            else:
                self._inflight.pop(task.key, None)
            self._cv.notify_all()

    def keys_idle(self, keys) -> bool:
        """True when none of ``keys`` is queued or in flight
        (byteps_tpu/core/scheduler.py:203)."""
        ks = set(keys)
        with self._cv:
            if ks & self._inflight.keys():
                return False
            return not any(item[1] in ks for item in self._heap)

    def stop(self) -> None:
        """Stop, and fail the tasks that never ran."""
        with self._cv:
            self._stopped = True
            tasks = [item[3] for item in self._heap]
            self._heap.clear()
            self._cv.notify_all()
        for task in tasks:
            task.group.partition_done(
                RuntimeError("scheduler stopped before task ran"))


def _variable_wire(task) -> bool:
    """A host codec wire that may be shorter than its bound (varint
    dithering, lossless); every other reply has its exact length."""
    return task.stack is not None and task.stack.variable_wire


class PartitionTask:
    """One partition of one push_pull (TensorTableEntry,
    common.h:221-264). Dense: ``in_view`` up, the reply into
    ``out_view``. Host-compressed: ``stack`` compresses ``in_view`` into
    ``wire`` and decompresses the reply into ``out_view``. Device tier:
    a prebuilt ``wire`` up, ``pull_len`` reply bytes into ``out_view``.
    Row-sparse: a prebuilt ``wire`` up under ``cmd``, the dense reply
    pulled under ``cmd_pull``."""

    __slots__ = ("ctx", "partition", "priority", "version", "in_view",
                 "out_view", "group", "cmd", "cmd_pull", "wire", "pull_len",
                 "stack", "step", "lease", "round_no", "attempt", "sent_to",
                 "enqueue_t", "push_len")

    def __init__(self, ctx, partition, priority, version, out_view, group,
                 cmd, wire=None, pull_len=None, in_view=None, stack=None,
                 step=0, cmd_pull=None):
        self.ctx: TensorContext = ctx
        self.partition: Partition = partition
        self.priority = priority
        self.version = version
        self.in_view = in_view     # np.uint8 dense input (or None)
        self.out_view = out_view   # np.uint8 reply/result buffer
        self.group: "TaskGroup" = group
        self.cmd = cmd             # command word of the push
        # the two-op pull's (the push's, but for a row-sparse push)
        self.cmd_pull = cmd if cmd_pull is None else cmd_pull
        self.wire = wire           # push payload, prebuilt or compressed
        self.pull_len = pull_len   # device tier: reply bytes
        self.stack = stack         # host codec stack (or None)
        self.step = step           # compression round of the stack
        self.lease = None          # arena scratch of a compressed reply
        self.round_no = 0          # per-key submission ordinal
        self.attempt = 0           # wire retries of this round so far
        self.sent_to = None        # the two-op push's server, which its pull asks
        self.enqueue_t = 0.0       # perf_counter at add_task
        self.push_len = None       # bytes the last push sent

    @property
    def epoch(self) -> int:
        """Replay stamp (round << 16) | attempt: the server folds each
        (key, sender, round) once, so a replayed push never counts twice.
        Round 0 (a task built outside ``submit``) sends 0, unstamped."""
        if not self.round_no:
            return 0
        return (self.round_no << 16) | (self.attempt & 0xFFFF)

    @property
    def key(self) -> int:
        return self.partition.key

    @property
    def nbytes(self) -> int:
        return self.partition.length


class TaskGroup:
    """Per-tensor completion: the shared counter and callback of the
    reference's partition fan-out (operations.cc:140-180)."""

    def __init__(self, ctx: TensorContext, total: int,
                 callback: Callable[[Optional[Exception]], None]):
        self.ctx = ctx
        self._remaining = total        # guarded-by: _mu
        self._mu = threading.Lock()
        self._callback = callback
        self._error: Optional[Exception] = None  # guarded-by: _mu

    def partition_done(self, err: Optional[Exception] = None) -> None:
        with self._mu:
            if err is not None and self._error is None:
                self._error = err
            self._remaining -= 1
            fire = self._remaining == 0
            final_err = self._error
        if fire:
            try:
                self._callback(final_err)
            except Exception:  # noqa: BLE001 - then re-raised
                log.exception("completion callback for %r raised; the "
                              "waiting handle may never resolve",
                              self.ctx.name)
                raise


class Handle:
    """Async completion handle."""

    def __init__(self, hid: int, name: str):
        self.id = hid
        self.name = name
        self._ev = threading.Event()
        self._err: Optional[Exception] = None
        self.result = None
        self._cb_mu = threading.Lock()
        self._cbs: List[Callable[[], None]] = []  # guarded-by: _cb_mu

    def done(self) -> bool:
        return self._ev.is_set()

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn()`` when the handle completes, on the completing
        thread (at once if it has). The train step's drain hangs on this:
        keep ``fn`` tiny."""
        with self._cb_mu:
            if not self._ev.is_set():
                self._cbs.append(fn)
                return
        fn()

    def wait(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"push_pull {self.name!r} timed out")
        if self._err is not None:
            raise self._err
        return self.result

    def _finish(self, result, err) -> None:
        self.result = result
        self._err = err
        with self._cb_mu:
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for fn in cbs:
            try:
                fn()
            except Exception:  # noqa: BLE001 - must not poison completion
                log.exception("handle done-callback for %r raised",
                              self.name)


class HandleManager:
    """int handle allocation, poll and wait (torch/handle_manager.cc:22)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._next = 0                           # guarded-by: _mu
        self._handles: Dict[int, Handle] = {}    # guarded-by: _mu

    def allocate(self, name: str) -> Handle:
        with self._mu:
            h = Handle(self._next, name)
            self._handles[h.id] = h
            self._next += 1
            return h

    def get(self, hid: int) -> Handle:
        with self._mu:
            try:
                return self._handles[hid]
            except KeyError:
                raise KeyError(f"unknown or already-synchronized handle "
                               f"{hid}") from None

    def poll(self, hid: int) -> bool:
        """True once the handle's round finished; a cleared handle reports
        done (PollHandle, torch/handle_manager.cc), one never allocated
        raises."""
        with self._mu:
            if hid < 0 or hid >= self._next:
                raise KeyError(f"handle {hid} was never allocated")
            h = self._handles.get(hid)
        return True if h is None else h.done()

    def discard(self, hid: int) -> None:
        """Drop a handle without its result (an abandoned round)."""
        with self._mu:
            self._handles.pop(hid, None)

    def wait_and_clear(self, hid: int, timeout=None):
        h = self.get(hid)
        try:
            out = h.wait(timeout)
        except TimeoutError:
            raise   # the round may still land: keep the handle
        except Exception:
            with self._mu:
                self._handles.pop(hid, None)
            raise
        with self._mu:
            self._handles.pop(hid, None)
        return out


class PipelineScheduler:
    """Priority-scheduled PUSHPULL, fused or two-op, with bounded retry.

    The dispatcher is the only consumer of the queue, so credit and
    priority order are decided in one place. An admitted task goes to the
    COMPRESS stage (host-compressed tasks, on the codec pool) and then to
    the WIRE stage, which sends one fused PUSHPULL and returns its thread;
    the reply lands in the task's buffer from the native recv loop, and
    the client's completion reactor hands the rest to a pool thread: the
    DECOMPRESS stage, or the finish. On the two-op path (``fused`` off,
    or a client without the fused op) the PUSH stage sends the push and
    the PULL stage, on the pull pool, blocks on the reply. Credit is held
    from admission until the finish, retries included.

    ``registry``: the tensor registry whose routing a failover migrates
    (None: a dead server's keys cannot move, and its rounds fail).
    ``config``: the wire knobs (fused_pushpull, wire_retry,
    wire_backoff_ms); None reads them from the environment. ``metrics``,
    ``profiler`` and ``telemetry``: the measurement plane (None: not
    measured)."""

    def __init__(self, client, num_threads: int = 8, credit_bytes: int = 0,
                 arena=None, registry=None, config: Optional[Config] = None,
                 metrics=None, profiler=None, telemetry=None):
        cfg = config if config is not None else Config.from_env()
        self._client = client
        self._fused = cfg.fused_pushpull and \
            getattr(client, "supports_fused", False)
        self._registry = registry
        self._retry_max = max(0, int(cfg.wire_retry))
        self._backoff_ms = max(1.0, float(cfg.wire_backoff_ms))
        self._stopping = False
        # backoff timers still to fire: id(task) -> (timer, task); stop()
        # fails them, so no handle waits on a retry that never runs
        self._retry_mu = threading.Lock()
        self._pending_retries: Dict[int, tuple] = {}  # guarded-by: _retry_mu
        # servers already failed over (one migration per death); held
        # across a whole migration, so a partition never reads a routing
        # table half re-targeted
        self._failover_mu = threading.Lock()
        self._migrated_servers: set = set()  # guarded-by: _failover_mu
        # moved keys not yet re-inited on their adoptive server: a task of
        # one that never failed (queued when its server died) re-inits it
        # before its first send there, since the server refuses a push to
        # a key it has no store for, and on the two-op path that refusal
        # fails the whole connection
        self._rehomed: set = set()           # guarded-by: _failover_mu
        self._failovers_done = 0             # guarded-by: _failover_mu
        # the fault counters (the JAX package's wire/retries,
        # wire/server_failovers and registry/migrations)
        self._count_mu = threading.Lock()
        self.retries = 0                     # guarded-by: _count_mu
        self.server_failovers = 0            # guarded-by: _count_mu
        self.key_migrations = 0              # guarded-by: _count_mu
        self._arena = arena        # scratch for compressed replies
        # the cross-barrier staleness credit (byteps_tpu/core/scheduler.py
        # :478-494), read by the train step's carry gate: the carried
        # drain submits a key's next round while its last may be in
        # flight. Fused PUSHPULL only: the fused reply is round-stamped
        # and parked by the server, and a bare two-op PULL could read
        # the previous round's aggregate
        self.xb_window = max(0, int(cfg.staleness)) \
            if self._fused and cfg.cross_barrier else 0
        self._queue = ScheduledQueue(credit_bytes, window=self.xb_window,
                                     metrics=metrics, profiler=profiler)
        # the measurement plane: stage histograms are cached per (stage,
        # key class) under their own lock, off the registry's
        self._metrics = metrics
        self._profiler = profiler
        self._telemetry = telemetry
        self._stage_mu = threading.Lock()
        self._stage_hists: Dict[tuple, object] = {}  # guarded-by: _stage_mu
        if metrics is not None:
            self._comp_pre = metrics.counter("compress/bytes_pre")
            self._comp_post = metrics.counter("compress/bytes_post")
            # made at once, so the snapshot shows zeros on a healthy fleet
            self._m_retries = metrics.counter("wire/retries")
            self._m_failovers = metrics.counter("wire/server_failovers")
            self._m_migrations = metrics.counter("registry/migrations")
        else:
            self._comp_pre = self._comp_post = None
            self._m_retries = self._m_failovers = self._m_migrations = None
        self._push_pool = concurrent.futures.ThreadPoolExecutor(
            num_threads, thread_name_prefix="bps-push")
        self._pull_pool = concurrent.futures.ThreadPoolExecutor(
            num_threads, thread_name_prefix="bps-pull")
        self._codec_pool = concurrent.futures.ThreadPoolExecutor(
            num_threads, thread_name_prefix="bps-codec")
        self._prio_mu = threading.Lock()
        self._key_priority: Dict[int, int] = {}  # guarded-by: _prio_mu
        self._round_seq: Dict[int, int] = {}     # guarded-by: _prio_mu
        self._export_ordinal = 0                 # guarded-by: _prio_mu
        # declared key (a leaf, or the parent of shard keys) -> ordinal
        self._export_order: Dict[int, int] = {}  # guarded-by: _prio_mu
        # wire bytes pushed, for the step's accounting
        self._bytes_mu = threading.Lock()
        self.bytes_pushed = 0                    # guarded-by: _bytes_mu
        self._dispatcher = threading.Thread(
            target=self._dispatch, name="bps-sched-dispatch", daemon=True)
        self._dispatcher.start()

    def keys_idle(self, keys) -> bool:
        """No queued, in-flight or backoff-parked task of any of ``keys``:
        the quiescence the elastic join and drain wait for before the
        routing moves under them (byteps_tpu/core/scheduler.py:598)."""
        ks = set(keys)
        with self._retry_mu:
            if any(t.key in ks for _, t in self._pending_retries.values()):
                return False
        return self._queue.keys_idle(ks)

    def _next_round(self, ctx: TensorContext) -> int:
        with self._prio_mu:
            r = self._round_seq.get(ctx.declared_key, 0) + 1
            self._round_seq[ctx.declared_key] = r
            return r

    def production_priority(self, ctx: TensorContext,
                            parent: Optional[TensorContext] = None) -> int:
        """Priority from the measured production order: the n-th distinct
        leaf to cross the streamed export gets ordinal n and priority -n,
        so the gradient the backward produces first is served first
        (the reference assumes "last layer first" through
        -declared_key). The priority is pinned for the key. ``parent``:
        the leaf that a shard key belongs to; all shards of one leaf are
        one production event and share its ordinal (the JAX package's
        rule, byteps_tpu/core/scheduler.py:613)."""
        with self._prio_mu:
            pr = self._key_priority.get(ctx.declared_key)
            if pr is None:
                anchor = ctx.declared_key if parent is None \
                    else parent.declared_key
                o = self._export_order.get(anchor)
                if o is None:
                    o = self._export_order[anchor] = self._export_ordinal
                    self._export_ordinal += 1
                if ctx.declared_key != anchor:
                    self._key_priority.setdefault(anchor, -o)
                pr = self._key_priority[ctx.declared_key] = -o
            return pr

    def _pin_priority(self, ctx: TensorContext,
                      priority: Optional[int]) -> int:
        """The first submission's priority is pinned per key: two queued
        rounds of one tensor with different priorities would otherwise
        be admitted out of round order, and the server counts pushes per
        worker and key in order. None = the pinned value, or
        -declared_key."""
        with self._prio_mu:
            pinned = self._key_priority.get(ctx.declared_key)
            if pinned is None:
                pinned = -ctx.declared_key if priority is None else priority
                self._key_priority[ctx.declared_key] = pinned
            return pinned

    @property
    def fused(self) -> bool:
        """True when the wire is one fused PUSHPULL per partition."""
        return self._fused

    def counters(self) -> Dict[str, int]:
        """The fault counters and the bytes pushed so far."""
        with self._count_mu:
            out = {"retries": self.retries,
                   "server_failovers": self.server_failovers,
                   "key_migrations": self.key_migrations}
        with self._bytes_mu:
            out["bytes_pushed"] = self.bytes_pushed
        return out

    def _wire_entry(self):
        return self._do_wire if self._fused else self._do_push

    def _dispatch(self) -> None:
        while True:
            task = self._queue.get_task()
            if task is None:
                return
            if task.stack is not None:
                self._submit_stage(self._codec_pool, self._do_compress, task)
            else:
                self._submit_stage(self._push_pool, self._wire_entry(), task)

    def _submit_stage(self, pool, fn, task: PartitionTask) -> None:
        try:
            pool.submit(fn, task)
        except RuntimeError as e:  # pool shut down mid-flight
            self._finish(task, e)

    def _do_compress(self, task: PartitionTask) -> None:
        from ..server.compressed import compress_partition
        t0 = time.perf_counter()
        try:
            task.wire = compress_partition(task.stack, task.in_view,
                                           task.step)
        except Exception as e:  # noqa: BLE001 - forwarded to the waiter
            self._finish(task, e)
            return
        finally:
            self._stage_done(task, "COMPRESS", t0)
        self._submit_stage(self._push_pool, self._wire_entry(), task)

    # ---- the measurement plane ---------------------------------------- #

    @staticmethod
    def _key_class(task) -> str:
        """"compressed" (a host codec stack), "wire" (a prebuilt payload:
        the device tier's or a row-sparse push) or "dense"."""
        if task.stack is not None:
            return "compressed"
        if task.wire is not None:
            return "wire"
        return "dense"

    def _stage_done(self, task, stage: str, t0: float) -> None:
        """One stage's latency: its (stage, class) histogram and the open
        StepReport's sample; a PULL sample is also the step's wire span."""
        if self._metrics is None:
            return
        dt = time.perf_counter() - t0
        key = (stage, self._key_class(task))
        with self._stage_mu:
            h = self._stage_hists.get(key)
            if h is None:
                h = self._stage_hists[key] = self._metrics.histogram(
                    f"scheduler/{stage.lower()}_us/{key[1]}")
        h.record_seconds(dt)
        prof = self._profiler.current() if self._profiler else None
        if prof is not None:
            prof.stage_sample(stage, dt)
            if stage == "PULL":
                prof.wire_span(t0, t0 + dt)

    def _account(self, task) -> None:
        """A finished partition's bytes: the push_pull rate both ways,
        and a compressed one's dense-equivalent and actual wire bytes
        (byteps_tpu/core/scheduler.py:1226-1251)."""
        if task.stack is not None:
            # actual lengths: a variable wire may be shorter than its bound
            sent = task.push_len if task.push_len is not None \
                else task.stack.wire_bytes()
            recvd = len(task.wire) if task.wire is not None \
                else task.stack.wire_bytes()
            moved = sent + recvd
            compressed = True
        elif task.wire is not None:
            down = task.pull_len if task.pull_len is not None \
                else task.nbytes
            moved = len(task.wire) + down
            # the device tier's compressed payload (its dense partitions
            # travel under the plain command word)
            compressed = task.pull_len is not None and \
                task.cmd in _COMPRESSED_CMDS
        else:
            moved, compressed = 2 * task.nbytes, False
        if self._telemetry is not None:
            self._telemetry.record(moved)
        if compressed and self._comp_pre is not None:
            self._comp_pre.inc(2 * task.nbytes)
            self._comp_post.inc(moved)

    # ---- bounded retry and server failover ---------------------------- #

    @staticmethod
    def _retryable(err: Exception) -> bool:
        """Wire failures retry (an error reply, a timeout, a lost
        connection, a failed send); a programming error (ValueError and
        the like) fails the round at once."""
        return isinstance(err, (RuntimeError, TimeoutError, OSError))

    def _fail_or_retry(self, task: PartitionTask, err: Exception) -> None:
        """A wire stage failed: replay the partition's whole exchange
        after the backoff, from the PUSH (or fused) stage; after the
        budget, fail the round with an error that names the flight dump
        (byteps_tpu/core/scheduler.py:778)."""
        if (self._stopping or task.attempt >= self._retry_max
                or not self._retryable(err)):
            if task.attempt > 0 and self._retryable(err):
                budget_ms = sum(
                    min(self._backoff_ms * (2 ** a), WIRE_BACKOFF_CAP_MS)
                    for a in range(task.attempt))
                err = self._fatal_wire_error(task, RuntimeError(
                    f"push_pull {task.ctx.name!r} key={task.key} failed "
                    f"after {task.attempt + 1} attempts over "
                    f"~{budget_ms:.0f}ms of backoff "
                    f"(BYTEPS_WIRE_RETRY={self._retry_max}, "
                    f"BYTEPS_WIRE_BACKOFF_MS={self._backoff_ms:g}): "
                    f"{err}"))
            self._finish(task, err)
            return
        task.attempt += 1
        flight.record("wire_retry", key=task.key,
                      detail=f"{task.ctx.name} attempt={task.attempt} "
                             f"server={task.partition.server} err={err}")
        with self._count_mu:
            self.retries += 1
        if self._m_retries is not None:
            self._m_retries.inc()
        # the reply scratch may be half written: never recycle it
        if task.lease is not None:
            task.lease.abandon()
            task.lease = None
        delay = min(self._backoff_ms * (2 ** (task.attempt - 1)),
                    WIRE_BACKOFF_CAP_MS) / 1000.0
        log.warning("push_pull %r key=%d: wire attempt %d failed (%s); "
                    "retrying in %.0fms (%d/%d)", task.ctx.name, task.key,
                    task.attempt, err, delay * 1e3, task.attempt,
                    self._retry_max)

        def fire():
            with self._retry_mu:
                if self._pending_retries.pop(id(task), None) is None:
                    return      # stop() claimed it and failed the task
            try:
                self._prepare_retry(task)
            except Exception as e:  # noqa: BLE001 - forwarded to the waiter
                # the dead fleet's fail-fast lands here (migrate_server
                # finds no survivor): it names the dump too
                self._finish(task, self._fatal_wire_error(task, e))
                return
            self._submit_stage(self._push_pool, self._wire_entry(), task)

        timer = threading.Timer(delay, fire)
        timer.daemon = True
        with self._retry_mu:
            if self._stopping:
                stopped = True
            else:
                stopped = False
                self._pending_retries[id(task)] = (timer, task)
        if stopped:
            self._finish(task, RuntimeError(
                "scheduler stopped with the retry pending"))
            return
        timer.start()

    def _fatal_wire_error(self, task: PartitionTask,
                          err: Exception) -> Exception:
        """A round fails for good: record it, dump the flight record and
        return the error with the dump's path appended."""
        flight.record("round_failed", key=task.key,
                      detail=f"{task.ctx.name} "
                             f"attempts={task.attempt + 1} err={err}")
        path = flight.dump(reason="wire-fail-fast")
        if not path:
            return err
        return RuntimeError(f"{err} — flight record dumped to {path}")

    def _prepare_retry(self, task: PartitionTask) -> None:
        """Before a retry: if the client reports the partition's server
        dead, migrate that server's keys (once per death) so the task's
        partition points at a survivor; then init any key of the tensor
        that its (new) server has no store for, and re-install a host
        codec's kwargs there. Raises when the server is dead and the key
        cannot move (no registry, or no survivor)."""
        # a migration re-targets the partitions, drops their init cache
        # entries and marks them re-homed under the failover lock: read
        # the route under it, never halfway through
        with self._failover_mu:
            srv = task.partition.server
        probe = getattr(self._client, "server_dead", None)
        if probe is not None and probe(srv):
            self._failover_server(srv)
            if task.partition.server == srv:
                raise RuntimeError(
                    f"server {srv} is dead and key migration is "
                    f"unavailable (no registry) — cannot re-route key "
                    f"{task.key}")
        self._reinstall(task)

    def _reinstall(self, task: PartitionTask) -> None:
        """Init the task's tensor where its server has no store for it (a
        sibling's failover may have moved its keys): ``ensure_init`` is a
        lookup for keys already inited, and an init push (the store, the
        init barrier of all workers) for a moved one. A host codec's
        server state died with its server: its kwargs go again (a
        matching COMP_INIT on a store that has it is a no-op)."""
        with self._failover_mu:
            gen = self._failovers_done
        ensure = getattr(self._client, "ensure_init", None)
        ctx = task.ctx
        if ensure is not None and ctx.nbytes and \
                ctx.nbytes == sum(p.length for p in ctx.partitions):
            ensure(ctx, ctx.nbytes)
        if task.stack is not None:
            comp_init = getattr(self._client, "comp_init", None)
            if comp_init is not None:
                comp_init(task.partition.server, task.key,
                          task.stack.kwargs_wire())
        with self._failover_mu:
            # a failover since the init read the cache: the key stays
            # marked, and the send re-inits it
            if gen == self._failovers_done:
                self._rehomed.discard(task.key)

    def _route(self, task: PartitionTask) -> Optional[int]:
        """The server to send the task to, read under the failover lock
        so that it and the re-init state agree; a key moved since the
        task was queued is re-inited there first. None when that failed
        (the task is then retried or failed)."""
        with self._failover_mu:
            server = task.partition.server
            moved = task.key in self._rehomed
        if not moved:
            return server
        try:
            self._reinstall(task)
        except Exception as e:  # noqa: BLE001 - retried or forwarded
            self._fail_or_retry(task, e)
            return None
        return task.partition.server

    def _failover_server(self, srv: int) -> None:
        with self._failover_mu:
            if srv in self._migrated_servers or self._registry is None:
                return
            migrated = self._registry.migrate_server(srv)
            self._migrated_servers.add(srv)
            if not migrated:
                return
            invalidate = getattr(self._client, "invalidate_init", None)
            if invalidate is not None:
                invalidate(migrated)
            self._rehomed.update(migrated)
            self._failovers_done += 1
            flight.record("server_failover", key=srv,
                          detail=f"server={srv} migrated_keys="
                                 f"{len(migrated)}")
            for k in migrated:
                flight.record("key_migration", key=k,
                              detail=f"from_server={srv}")
            with self._count_mu:
                self.server_failovers += 1
                self.key_migrations += len(migrated)
            if self._m_failovers is not None:
                self._m_failovers.inc()
                self._m_migrations.inc(len(migrated))
        log.warning("scheduler: server %d declared dead; %d key(s) "
                    "migrated to survivors, re-routing in-flight retries",
                    srv, len(migrated))

    def _reply_buffer(self, task: PartitionTask) -> np.ndarray:
        """Where the reply lands: a compressed reply in (arena) scratch,
        which DECOMPRESS decodes into ``out_view``; the rest in
        ``out_view``."""
        if task.stack is None:
            return task.out_view
        wb = task.stack.wire_bytes()
        if self._arena is not None:
            task.lease = self._arena.checkout(f"pull:{task.key}", wb)
            return task.lease.buf
        return np.empty(wb, np.uint8)

    def _count_push(self, n: int) -> None:
        with self._bytes_mu:
            self.bytes_pushed += n

    def _do_wire(self, task: PartitionTask) -> None:
        """The fused WIRE stage: one PUSHPULL message; the reactor runs
        the continuation when the round's aggregate has landed."""
        server = self._route(task)
        if server is None:
            return
        buf = task.wire if task.wire is not None else task.in_view
        try:
            reply = self._reply_buffer(task)
        except Exception as e:  # noqa: BLE001 - forwarded to the waiter
            self._finish(task, e)
            return
        # a dense reply is the whole partition, a device-tier reply its
        # wire and a fixed host wire its bound; a variable host wire
        # (varint dithering, lossless) may be shorter than its bound
        want = task.pull_len if task.pull_len is not None else len(reply)
        short_ok = _variable_wire(task)
        task.push_len = len(buf)
        t0 = time.perf_counter()

        def on_done(got: int, err) -> None:
            # submit to completion: the wire and the aggregation wait
            self._stage_done(task, "PULL", t0)
            if err is None and got != want and not (short_ok and got < want):
                err = RuntimeError(
                    f"fused pushpull reply for {task.ctx.name!r} "
                    f"key={task.key} is {got} bytes, expected {want}")
            if err is not None:
                self._fail_or_retry(task, err)
                return
            if task.stack is not None:
                task.wire = reply[:got]
                self._submit_stage(self._codec_pool, self._do_decompress,
                                   task)
                return
            try:
                self._pull_pool.submit(self._finish, task, None)
            except RuntimeError as e:
                self._finish(task, e)

        # counted before the send: the reply may finish the round before
        # the send call returns
        self._count_push(len(buf))
        try:
            self._client.zpushpull_async(
                server, task.key, buf, reply, task.cmd, on_done,
                epoch=task.epoch)
        except Exception as e:  # noqa: BLE001 - retried or forwarded
            self._fail_or_retry(task, e)
            return
        # the send's wall alone: the aggregation wait is the PULL sample
        self._stage_done(task, "PUSH", t0)

    def _do_push(self, task: PartitionTask) -> None:
        """The two-op PUSH stage: send the push (the ACK drains in the
        background; a reject surfaces on the pull), then queue the PULL
        (byteps_tpu/core/scheduler.py:1090)."""
        server = self._route(task)
        if server is None:
            return
        buf = task.wire if task.wire is not None else task.in_view
        self._count_push(len(buf))
        task.sent_to = server
        task.push_len = len(buf)
        t0 = time.perf_counter()
        try:
            self._client.zpush_async(server, task.key, buf, task.cmd,
                                     epoch=task.epoch)
        except Exception as e:  # noqa: BLE001 - retried or forwarded
            self._fail_or_retry(task, e)
            return
        finally:
            self._stage_done(task, "PUSH", t0)
        self._submit_stage(self._pull_pool, self._do_pull, task)

    def _do_pull(self, task: PartitionTask) -> None:
        """The two-op PULL stage: block on the key's aggregate. A failure
        replays the whole exchange from the push: the epoch stamp dedups
        the replayed push (byteps_tpu/core/scheduler.py:1136)."""
        t0 = time.perf_counter()
        try:
            reply = self._reply_buffer(task)
            got = self._client.zpull(
                task.sent_to, task.key, reply, task.cmd_pull,
                exact=task.pull_len is None and not _variable_wire(task))
            if task.pull_len is not None and got != task.pull_len:
                raise RuntimeError(
                    f"pull reply for {task.ctx.name!r} key={task.key} is "
                    f"{got} bytes, expected {task.pull_len}")
        except Exception as e:  # noqa: BLE001 - retried or forwarded
            self._fail_or_retry(task, e)
            return
        finally:
            self._stage_done(task, "PULL", t0)
        if task.stack is not None:
            task.wire = reply[:got]
            self._submit_stage(self._codec_pool, self._do_decompress, task)
        else:
            self._finish(task, None)

    def _do_decompress(self, task: PartitionTask) -> None:
        from ..server.compressed import decompress_partition
        t0 = time.perf_counter()
        try:
            decompress_partition(task.stack, task.wire, task.out_view)
        except Exception as e:  # noqa: BLE001 - forwarded to the waiter
            self._finish(task, e)
            return
        finally:
            self._stage_done(task, "DECOMPRESS", t0)
        self._finish(task, None)

    def _finish(self, task: PartitionTask, err: Optional[Exception]) -> None:
        if task.lease is not None:
            # released before the key leaves the in-flight set, so the
            # key's next round finds the slot free; on error the reply
            # may still be written: never recycle it
            if err is None:
                task.lease.release()
            else:
                task.lease.abandon()
            task.lease = None
        self._queue.report_finish(task)
        if err is None:
            self._account(task)
        task.group.partition_done(err)

    def submit(self, ctx: TensorContext, flat_in: np.ndarray,
               handle: Handle, average: bool, num_workers: int,
               version: int = 0, priority: Optional[int] = None,
               comp=None, out: Optional[np.ndarray] = None) -> None:
        """Enqueue every partition of one flat host tensor; ``handle``
        resolves to the flat result (the cross-worker sum, divided by
        ``num_workers`` when ``average`` and there is more than one)
        when the last partition lands. ``comp``: a
        ``server.compressed.CompressedTensor``, whose partition stacks
        run in the COMPRESS and DECOMPRESS stages (a partition without
        one travels dense) and whose round counter seeds them. ``out``:
        the result buffer (an arena slot; it may be ``flat_in`` itself:
        each partition's push is sent before its reply can land), used
        if it fits exactly; the caller keeps it until the handle
        resolves and it is done reading."""
        if comp is not None:
            step = comp.begin_round()   # installs the codecs on first use
            flat_in = np.ascontiguousarray(flat_in, np.float32)
        else:
            step = 0
            self._client.ensure_init(ctx, flat_in.nbytes)
        # bfloat16 bits come in a uint16 array: the key's dtype says so
        bf16 = ctx.dtype == DataType.BFLOAT16 and comp is None
        dtype = DataType.BFLOAT16 if bf16 else DataType.from_np(flat_in.dtype)
        cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, dtype)
        cmd_comp = get_command_type(RequestType.COMPRESSED_PUSH_PULL, dtype)
        if not usable_staging(out, flat_in.dtype, flat_in.nbytes):
            out = np.empty_like(flat_in)
        in_view = flat_in.view(np.uint8)
        out_view = out.view(np.uint8)

        def on_complete(err: Optional[Exception]) -> None:
            if err is None and average and num_workers > 1:
                if bf16:
                    # in f32, rounded to bfloat16 once, as the JAX
                    # package's ml_dtypes division rounds
                    torch.from_numpy(out.view(np.int16)).view(
                        torch.bfloat16).div_(num_workers)
                elif np.issubdtype(out.dtype, np.integer):
                    trunc_divide_inplace(out, num_workers)
                else:
                    np.divide(out, num_workers, out=out)
            handle._finish(out if err is None else None, err)

        group = TaskGroup(ctx, len(ctx.partitions), on_complete)
        priority = self._pin_priority(ctx, priority)
        round_no = self._next_round(ctx)
        for i, p in enumerate(ctx.partitions):
            stack = comp.stacks[i] if comp is not None else None
            lo, hi = p.offset, p.offset + p.length
            task = PartitionTask(
                ctx, p, priority, version, out_view[lo:hi], group,
                cmd if stack is None else cmd_comp,
                in_view=in_view[lo:hi], stack=stack, step=step)
            task.round_no = round_no
            try:
                self._queue.add_task(task)
            except RuntimeError as e:
                group.partition_done(e)

    def submit_wire(self, ctx: TensorContext, wires: List[np.ndarray],
                    reply_lens: List[int], cmds: List[int], handle: Handle,
                    version: int = 0, priority: Optional[int] = None,
                    reply_bufs: Optional[List[np.ndarray]] = None) -> None:
        """Prebuilt-wire push_pull for device-compressed tensors:
        partition i pushes ``wires[i]`` with ``cmds[i]`` and receives
        ``reply_lens[i]`` bytes; the handle resolves to the list of reply
        buffers. ``reply_bufs``: caller-owned (arena) reply buffers,
        ignored unless each fits its reply exactly."""
        if (reply_bufs is not None and len(reply_bufs) == len(reply_lens)
                and all(usable_staging(b, np.dtype(np.uint8), rl)
                        for b, rl in zip(reply_bufs, reply_lens))):
            replies = list(reply_bufs)
        else:
            replies = [np.empty(rl, np.uint8) for rl in reply_lens]

        def on_complete(err: Optional[Exception]) -> None:
            handle._finish(replies if err is None else None, err)

        group = TaskGroup(ctx, len(ctx.partitions), on_complete)
        priority = self._pin_priority(ctx, priority)
        round_no = self._next_round(ctx)
        for i, p in enumerate(ctx.partitions):
            task = PartitionTask(ctx, p, priority, version, replies[i],
                                 group, cmds[i], wire=wires[i],
                                 pull_len=reply_lens[i])
            task.round_no = round_no
            try:
                self._queue.add_task(task)
            except RuntimeError as e:
                group.partition_done(e)

    def submit_rowsparse(self, ctx: TensorContext, host2d: np.ndarray,
                         handle: Handle, average: bool, num_workers: int,
                         version: int = 0, priority: Optional[int] = None,
                         out: Optional[np.ndarray] = None) -> int:
        """Row-sparse push_pull (byteps_tpu/core/scheduler.py:1382-1432):
        per row-aligned partition the nonzero rows of the [rows, width]
        f32 ``host2d`` become a prebuilt push payload and the reply is the
        partition's dense aggregate, with the priority, credit, retry and
        round numbering of dense traffic. ``handle`` resolves to the
        [rows, width] sum (mean when ``average``). ``out``: a flat f32
        result buffer (it may be ``host2d`` itself: the payloads are built
        here). Returns the bytes of the payloads."""
        from ..server.client import build_rowsparse_payload, nonzero_rows

        host2d = np.ascontiguousarray(host2d, np.float32)
        rows, width = host2d.shape
        self._client.ensure_init(ctx, host2d.nbytes)
        cmd_sparse = get_command_type(RequestType.ROW_SPARSE_PUSH_PULL,
                                      DataType.FLOAT32)
        cmd_dense = get_command_type(RequestType.DEFAULT_PUSH_PULL,
                                     DataType.FLOAT32)
        nz = nonzero_rows(host2d)
        wires = [build_rowsparse_payload(p, nz, host2d)
                 for p in ctx.partitions]
        if not usable_staging(out, np.dtype(np.float32), rows * width * 4):
            out = np.empty(rows * width, np.float32)
        out_view = out.view(np.uint8)

        def on_complete(err: Optional[Exception]) -> None:
            if err is None and average and num_workers > 1:
                np.divide(out, num_workers, out=out)
            handle._finish(out.reshape(rows, width) if err is None else None,
                           err)

        group = TaskGroup(ctx, len(ctx.partitions), on_complete)
        priority = self._pin_priority(ctx, priority)
        round_no = self._next_round(ctx)
        for p, wire in zip(ctx.partitions, wires):
            task = PartitionTask(
                ctx, p, priority, version,
                out_view[p.offset:p.offset + p.length], group, cmd_sparse,
                wire=wire, cmd_pull=cmd_dense)
            task.round_no = round_no
            try:
                self._queue.add_task(task)
            except RuntimeError as e:
                group.partition_done(e)
        return sum(len(w) for w in wires)

    def stop(self) -> None:
        """Fail the retries still waiting and the queued tasks, and stop
        the stage threads; in-flight fused requests are failed by the
        client's close."""
        with self._retry_mu:
            self._stopping = True
            pending = list(self._pending_retries.values())
            self._pending_retries.clear()
        for timer, task in pending:
            timer.cancel()
            self._finish(task, RuntimeError(
                "scheduler stopped with the wire retry still pending"))
        self._queue.stop()
        self._dispatcher.join(timeout=5)
        for pool in (self._codec_pool, self._push_pool, self._pull_pool):
            pool.shutdown(wait=False, cancel_futures=True)
