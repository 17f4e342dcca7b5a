"""The crash flight recorder: the worker's ring of fault events, merged
with every server's.

Port of byteps_tpu/core/flight.py. A bounded ring of structured events
(wire retries, server failovers, key migrations, round failures, health
anomalies, efficiency drops) that the fault paths record as they happen,
dumped as JSON when a round fails for good, on SIGTERM, or by
``dump_flight_record()``. The native server keeps its own ring
(``ps.cc``'s FlightRec: replay dedups, codec rejects, chaos drops,
worker departures), which ``core/state.py``'s collector reads over the
FLIGHT_DRAIN control op (``set_server_collector``) with each server's
clock offset, so the dump's ``merged`` list is one timeline on the
worker's steady clock.

A module-level recorder, so a call site records without plumbing;
``configure`` arms a fresh one at each ``init``. The SIGTERM handler
(``install_signal_handler``) runs the term hooks first, in their pinned
order (the time series, ``TERM_ORDER_TIMESERIES``, then the perf
archive, ``TERM_ORDER_ARCHIVE``), then the dump, then the handler that
was installed before it. The dump goes under BYTEPS_FLIGHT_DIR (default
``./flight``).
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder", "configure", "get_recorder", "record",
    "set_server_collector", "dump", "install_signal_handler",
    "add_term_hook", "run_term_hooks", "estimate_clock_offset",
    "TERM_ORDER_TIMESERIES", "TERM_ORDER_ARCHIVE",
]


def estimate_clock_offset(samples) -> tuple:
    """NTP-style clock offset from CLOCK_PROBE echoes (byteps_tpu/utils/
    tracing.py:33-62). Each sample is ``(t0, t1, t2, t3)``: client send,
    server recv, server send, client recv, t0 and t3 on the client's
    steady clock, t1 and t2 on the server's. The least-delayed echo
    decides: ``offset = ((t1 - t0) + (t2 - t3)) / 2``, within half its
    round trip. Returns ``(offset_ns, err_bound_ns)`` with
    ``server_clock - offset`` the client's clock."""
    best = None
    for t0, t1, t2, t3 in samples:
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            continue  # a clock step mid-probe
        off = ((t1 - t0) + (t2 - t3)) // 2
        if best is None or rtt < best[1]:
            best = (off, rtt)
    if best is None:
        raise ValueError("no usable clock probe echo")
    return int(best[0]), int(best[1] // 2 + 1)


class FlightRecorder:
    """Fixed-capacity drop-oldest event ring. Each event is
    ``(ts_ns, kind, key, rid, detail)`` with ``ts_ns`` on the same
    steady clock (``time.monotonic_ns``) the native rings and the
    clock-offset estimator use, so worker and server events sort onto
    one causal timeline."""

    def __init__(self, capacity: int = 2048, enabled: bool = True):
        self.capacity = max(16, int(capacity))
        self.enabled = enabled
        self._mu = threading.Lock()
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._w = 0        # guarded-by: _mu (total events ever recorded)
        self._dropped = 0  # guarded-by: _mu

    def record(self, kind: str, key: int = 0, rid: int = 0,
               detail: str = "") -> None:
        if not self.enabled:
            return
        ev = (time.monotonic_ns(), str(kind), int(key), int(rid),
              str(detail)[:256])
        with self._mu:
            if self._w >= self.capacity:
                self._dropped += 1
            self._slots[self._w % self.capacity] = ev
            self._w += 1

    def events(self) -> List[dict]:
        """Ring contents, oldest first (non-destructive — like the
        server's FLIGHT_DRAIN, a read never steals a crash dump's
        evidence)."""
        with self._mu:
            w = self._w
            start = max(0, w - self.capacity)
            evs = [self._slots[i % self.capacity] for i in range(start, w)]
        return [{"ts_ns": e[0], "kind": e[1], "key": e[2], "rid": e[3],
                 "detail": e[4]} for e in evs if e is not None]

    def snapshot(self) -> dict:
        """The ``flight`` section of ``get_metrics()`` (fixed keys)."""
        with self._mu:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "events": self._w, "dropped": self._dropped}


# armed by configure() at init(); a disabled recorder makes every
# record() a flag check, so call sites never branch
_recorder = FlightRecorder(enabled=False)
# () -> [{"server": idx, "offset_ns": o, "events": [...]}] — set by
# core/state.py when a PS client with the control ops is connected;
# best-effort (a dead fleet dumps worker events alone)
_server_collector: Optional[Callable[[], list]] = None
# best-effort extra work on the SIGTERM path (timeseries JSONL dump,
# perf-archive flush, core/ledger.py), run BEFORE the flight dump in
# PINNED (order, registration-seq) order — registration order alone
# raced: whichever module wired up first dumped first, so the flight
# dump could observe a half-flushed archive or the archive could miss
# the timeseries tail. Reset per configure() so a re-init never
# accumulates stale hooks.
_term_hooks: List[tuple] = []  # [(order, seq, fn)]
_term_seq = 0
# canonical orders (timeseries → archive → flight dump last, which is
# hardcoded in _on_term after every hook)
TERM_ORDER_TIMESERIES = 10
TERM_ORDER_ARCHIVE = 50
_dump_dir = "./flight"
_prev_sigterm = None
_handler_installed = False
# the partitions of a failing round may dump at once, to one path
_dump_mu = threading.Lock()


def configure(capacity: int = 2048, enabled: bool = True,
              dump_dir: str = "./flight") -> FlightRecorder:
    """Fresh recorder per init lifecycle (counters start clean, like
    the metrics registry); returns it for the state to own."""
    global _recorder, _dump_dir, _server_collector
    _recorder = FlightRecorder(capacity=capacity, enabled=enabled)
    _dump_dir = dump_dir
    _server_collector = None
    del _term_hooks[:]
    return _recorder


def add_term_hook(fn: Callable[[], None],
                  order: int = TERM_ORDER_ARCHIVE) -> None:
    """Register extra SIGTERM-path work (timeseries dump, perf-archive
    flush): hooks run sorted by ``(order, registration seq)`` before
    the flight dump — timeseries (TERM_ORDER_TIMESERIES) → archive
    (TERM_ORDER_ARCHIVE, default) → flight, regardless of which module
    registered first. Each hook is best-effort."""
    global _term_seq
    _term_hooks.append((int(order), _term_seq, fn))
    _term_seq += 1


def run_term_hooks() -> None:
    """Run the SIGTERM hook chain in pinned order (shared by _on_term
    and the combined-dump test path); each hook best-effort."""
    for _, _, hook in sorted(_term_hooks, key=lambda t: (t[0], t[1])):
        try:
            hook()
        except Exception:  # noqa: BLE001 - hooks must not block dump
            pass


def get_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, key: int = 0, rid: int = 0, detail: str = "") -> None:
    """THE event entry point for fault-path call sites (scheduler
    retries/failovers, registry migrations, codec switches)."""
    _recorder.record(kind, key=key, rid=rid, detail=detail)


def set_server_collector(fn: Optional[Callable[[], list]]) -> None:
    global _server_collector
    _server_collector = fn


def dump(path: Optional[str] = None, reason: str = "manual"
         ) -> Optional[str]:
    """Write the merged flight record as JSON and return its path
    (None when the recorder is disabled and no server has events, or the
    file cannot be written; never raises).

    Shape: worker events plus a per-server section (snapshot-drained
    over FLIGHT_DRAIN when a collector is wired), and one ``merged``
    causal timeline — server timestamps mapped onto the worker's
    steady clock via each server's estimated offset, then everything
    sorted by aligned time. Best-effort by construction: a dead fleet
    still dumps the worker's half."""
    worker_events = _recorder.events()
    servers = []
    if _server_collector is not None:
        try:
            servers = _server_collector() or []
        except Exception:  # noqa: BLE001 - the dump must never raise
            servers = []
    if not _recorder.enabled and not any(
            s.get("events") for s in servers):
        return None
    merged = [dict(e, source="worker") for e in worker_events]
    for entry in servers:
        off = int(entry.get("offset_ns", 0))
        for e in entry.get("events", []):
            merged.append({
                "ts_ns": int(e.get("ts_ns", 0)) - off,  # aligned
                "kind": e.get("kind"), "key": e.get("key", 0),
                "rid": e.get("rid", 0),
                "detail": f"sender={e.get('sender', 0)} "
                          f"detail={e.get('detail', 0)}",
                "source": f"server{entry.get('server', 0)}"})
    merged.sort(key=lambda e: e["ts_ns"])
    out_path = path
    if out_path is None:
        out_path = os.path.join(_dump_dir, f"flight-{os.getpid()}.json")
    doc = {
        "reason": reason,
        "pid": os.getpid(),
        "recorded_at_monotonic_ns": time.monotonic_ns(),
        "worker": {"events": worker_events,
                   "stats": _recorder.snapshot()},
        "servers": servers,
        "merged": merged,
    }
    tmp = f"{out_path}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with _dump_mu:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            # whole or not at all: a reader never sees a half-written dump
            os.replace(tmp, out_path)
    except OSError:
        return None
    return out_path


def install_signal_handler() -> None:
    """Dump the flight record on SIGTERM (the fleet-kill shape), then
    chain to whatever handler was installed before us. Main-thread
    only (signal.signal raises elsewhere); idempotent."""
    global _prev_sigterm, _handler_installed
    if _handler_installed:
        return

    def _on_term(signum, frame):
        run_term_hooks()
        path = dump(reason="SIGTERM")
        if path:
            import sys
            sys.stderr.write(
                f"[byteps_tpu_torch] SIGTERM: flight record dumped to "
                f"{path}\n")
        prev = _prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
        _handler_installed = True
    except ValueError:
        pass  # not the main thread (embedded/test harness): skip
