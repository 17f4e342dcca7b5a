"""Host-side pipeline scheduler of the PS path.

Port of byteps_tpu/core/scheduler.py, trimmed to what the device-
compressed train step uses: prebuilt wire payloads (``submit_wire``)
through the fused WIRE stage, one PUSHPULL message per partition, with
the reference's worker-side scheduling (scheduled_queue.cc,
core_loops.cc):

- ``ScheduledQueue``: tasks ordered by (priority desc, key asc), admitted
  while the in-flight byte credit lasts (BYTEPS_SCHEDULING_CREDIT), and
  at most one task of a key in flight, so two rounds of one tensor never
  interleave on the server;
- ``PipelineScheduler``: the dispatcher admits tasks and hands them to
  the WIRE stage; the client's completion reactor finishes them; the
  per-tensor ``TaskGroup`` fires the handle when the last partition
  lands;
- ``HandleManager``: integer handles (torch/handle_manager.cc).

Each task carries its key's round number in the epoch stamp. Priority is
-declared_key by default (front-of-model tensors win ties,
tensorflow/ops.cc:155-158), pinned per key at its first submission.

Not yet ported: the two-op PUSH/PULL fallback, wire retry and server
failover, the host-codec COMPRESS/DECOMPRESS stages, dense and rowsparse
submission, production-order priority and the codec plane.
"""

from __future__ import annotations

import concurrent.futures
import heapq
import itertools
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.logging import log
from .arena import usable_staging
from .types import Partition, TensorContext

# credit when scheduling is off: effectively unlimited (the reference's
# 32 GB, scheduled_queue.cc:33-45)
UNLIMITED_CREDIT = 32 << 30


class ScheduledQueue:
    """Priority + credit gated task queue (scheduled_queue.cc)."""

    def __init__(self, credit_bytes: int = 0):
        self._credit = (credit_bytes if credit_bytes > 0
                        else UNLIMITED_CREDIT)  # guarded-by: _cv
        self._capacity = self._credit
        self._cv = threading.Condition(threading.Lock())
        self._heap: List = []                  # guarded-by: _cv
        self._counter = itertools.count()
        self._stopped = False                  # guarded-by: _cv
        self._inflight: Dict[int, int] = {}    # guarded-by: _cv

    def add_task(self, task: "PartitionTask") -> None:
        with self._cv:
            if self._stopped:
                raise RuntimeError("scheduler stopped")
            # seq keeps same-key tasks in submission order
            heapq.heappush(self._heap, (-task.priority, task.key,
                                        next(self._counter), task))
            self._cv.notify()

    def get_task(self) -> Optional["PartitionTask"]:
        """Block until a task is admitted (credit left, key not in
        flight) or the queue stops."""
        with self._cv:
            while True:
                if self._stopped:
                    return None
                task = self._pop_admissible_locked()
                if task is not None:
                    self._credit -= task.nbytes
                    self._inflight[task.key] = \
                        self._inflight.get(task.key, 0) + 1
                    return task
                self._cv.wait(timeout=0.1)

    def _pop_admissible_locked(self) -> Optional["PartitionTask"]:
        """Pop the highest-priority admissible task; in-flight keys are
        skipped, and a credit-starved head blocks admission (no smaller
        task overtakes it, scheduled_queue.cc:136-149)."""
        skipped: List = []
        found = None
        while self._heap:
            item = heapq.heappop(self._heap)
            t = item[3]
            if self._inflight.get(t.key, 0) >= 1:
                skipped.append(item)
                continue
            # a task above the whole capacity runs once credit is full
            if t.nbytes <= self._credit or self._credit >= self._capacity:
                found = t
            else:
                skipped.append(item)
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


class PartitionTask:
    """One partition of one push_pull (TensorTableEntry,
    common.h:221-264): a prebuilt wire payload up, a reply buffer down."""

    __slots__ = ("ctx", "partition", "priority", "version", "out_view",
                 "group", "cmd", "wire", "pull_len", "round_no")

    def __init__(self, ctx, partition, priority, version, out_view, group,
                 cmd, wire, pull_len):
        self.ctx: TensorContext = ctx
        self.partition: Partition = partition
        self.priority = priority
        self.version = version
        self.out_view = out_view   # np.uint8 reply buffer
        self.group: "TaskGroup" = group
        self.cmd = cmd             # command word of push and reply
        self.wire = wire           # prebuilt push payload
        self.pull_len = pull_len   # reply bytes
        self.round_no = 0          # per-key submission ordinal

    @property
    def epoch(self) -> int:
        """Replay stamp (round << 16) | attempt; no retries here, so the
        attempt is 0. The server folds each (key, sender, round) once."""
        return self.round_no << 16

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

    def wait(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"push_pull {self.name!r} timed out")
        if self._err is not None:
            raise self._err
        return self.result

    def _finish(self, result, err) -> None:
        self.result = result
        self._err = err
        self._ev.set()


class HandleManager:
    """int handle allocation and wait (torch/handle_manager.cc:22)."""

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

    def wait_and_clear(self, hid: int, timeout=None):
        with self._mu:
            h = self._handles[hid]
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
    """Priority-scheduled fused PUSHPULL of prebuilt wire payloads.

    The dispatcher is the only consumer of the queue, so credit and
    priority order are decided in one place. An admitted task goes to the
    WIRE stage, which sends one fused PUSHPULL and returns its thread;
    the reply lands in the task's buffer from the native recv loop, and
    the client's completion reactor hands the finish to a pool thread.
    Credit is held from admission until the reply."""

    def __init__(self, client, num_threads: int = 8, credit_bytes: int = 0):
        if not getattr(client, "supports_fused", False):
            raise NotImplementedError(
                "the two-op PUSH/PULL pipeline is not yet ported to "
                "byteps_tpu_torch: the client must speak the fused "
                "PUSHPULL op")
        self._client = client
        self._queue = ScheduledQueue(credit_bytes)
        self._push_pool = concurrent.futures.ThreadPoolExecutor(
            num_threads, thread_name_prefix="bps-push")
        self._pull_pool = concurrent.futures.ThreadPoolExecutor(
            num_threads, thread_name_prefix="bps-pull")
        self._prio_mu = threading.Lock()
        self._key_priority: Dict[int, int] = {}  # guarded-by: _prio_mu
        self._round_seq: Dict[int, int] = {}     # guarded-by: _prio_mu
        # wire bytes pushed, for the step's accounting
        self._bytes_mu = threading.Lock()
        self.bytes_pushed = 0                    # guarded-by: _bytes_mu
        self._dispatcher = threading.Thread(
            target=self._dispatch, name="bps-sched-dispatch", daemon=True)
        self._dispatcher.start()

    def _next_round(self, ctx: TensorContext) -> int:
        with self._prio_mu:
            r = self._round_seq.get(ctx.declared_key, 0) + 1
            self._round_seq[ctx.declared_key] = r
            return r

    def _pin_priority(self, ctx: TensorContext,
                      priority: Optional[int]) -> int:
        """The first submission's priority is pinned per key: two queued
        rounds of one tensor with different priorities would otherwise
        be admitted out of round order, and the server counts pushes per
        worker and key in order. None = -declared_key."""
        with self._prio_mu:
            pinned = self._key_priority.get(ctx.declared_key)
            if pinned is None:
                pinned = -ctx.declared_key if priority is None else priority
                self._key_priority[ctx.declared_key] = pinned
            return pinned

    def _dispatch(self) -> None:
        while True:
            task = self._queue.get_task()
            if task is None:
                return
            try:
                self._push_pool.submit(self._do_wire, task)
            except RuntimeError as e:  # pool shut down mid-flight
                self._finish(task, e)

    def _do_wire(self, task: PartitionTask) -> None:
        """The fused WIRE stage: one PUSHPULL message; the reactor runs
        the continuation when the round's aggregate has landed."""
        reply = task.out_view

        def on_done(got: int, err) -> None:
            if err is None and got != task.pull_len:
                err = RuntimeError(
                    f"fused pushpull reply for {task.ctx.name!r} "
                    f"key={task.key} is {got} bytes, expected "
                    f"{task.pull_len}")
            try:
                self._pull_pool.submit(self._finish, task, err)
            except RuntimeError as e:
                self._finish(task, e)

        # counted before the send: the reply may finish the round before
        # the send call returns
        with self._bytes_mu:
            self.bytes_pushed += len(task.wire)
        try:
            self._client.zpushpull_async(
                task.partition.server, task.key, task.wire, reply, task.cmd,
                on_done, epoch=task.epoch)
        except Exception as e:  # noqa: BLE001 - forwarded to the waiter
            self._finish(task, e)

    def _finish(self, task: PartitionTask, err: Optional[Exception]) -> None:
        self._queue.report_finish(task)
        task.group.partition_done(err)

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
                                 group, cmds[i], wires[i], reply_lens[i])
            task.round_no = round_no
            try:
                self._queue.add_task(task)
            except RuntimeError as e:
                group.partition_done(e)

    def stop(self) -> None:
        """Fail queued tasks and stop the stage threads; in-flight fused
        requests are failed by the client's close."""
        self._queue.stop()
        self._dispatcher.join(timeout=5)
        for pool in (self._push_pool, self._pull_pool):
            pool.shutdown(wait=False, cancel_futures=True)
