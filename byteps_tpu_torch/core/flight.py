"""Crash flight recorder: the worker's ring of fault events.

Port of byteps_tpu/core/flight.py, trimmed to what the wire retry and its
fail-fast need: a bounded ring of structured events that the fault paths
record as they happen (``wire_retry``, ``server_failover``,
``key_migration``, ``round_failed``, the JAX package's names), and
``dump``, which writes it as JSON when a round fails for good, so the
error can name the file. A module-level recorder, so a call site records
without plumbing; ``configure`` arms a fresh one at ``init``.

The dump goes under BYTEPS_FLIGHT_DIR (default ``./flight``). Not ported:
the server half (the FLIGHT_DRAIN control op), the SIGTERM handler and
its hooks.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

__all__ = ["FlightRecorder", "configure", "get_recorder", "record", "dump"]


class FlightRecorder:
    """Fixed-capacity drop-oldest event ring. Each event is ``(ts_ns,
    kind, key, rid, detail)``, ``ts_ns`` on ``time.monotonic_ns``."""

    def __init__(self, capacity: int = 2048, enabled: bool = True):
        self.capacity = max(16, int(capacity))
        self.enabled = enabled
        self._mu = threading.Lock()
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._w = 0        # guarded-by: _mu (events ever recorded)
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
        """The ring, oldest first."""
        with self._mu:
            w = self._w
            evs = [self._slots[i % self.capacity]
                   for i in range(max(0, w - self.capacity), w)]
        return [{"ts_ns": e[0], "kind": e[1], "key": e[2], "rid": e[3],
                 "detail": e[4]} for e in evs if e is not None]

    def snapshot(self) -> dict:
        with self._mu:
            return {"enabled": self.enabled, "capacity": self.capacity,
                    "events": self._w, "dropped": self._dropped}


# armed by configure() at init(); until then record() is a flag check
_recorder = FlightRecorder(enabled=False)
_dump_dir = "./flight"
# the partitions of a failing round may dump at once, to one path
_dump_mu = threading.Lock()


def configure(capacity: int = 2048, enabled: bool = True,
              dump_dir: Optional[str] = None) -> FlightRecorder:
    """A fresh recorder for an ``init`` (its events start clean);
    ``dump_dir`` defaults to BYTEPS_FLIGHT_DIR, else ``./flight``."""
    global _recorder, _dump_dir
    _recorder = FlightRecorder(capacity=capacity, enabled=enabled)
    _dump_dir = dump_dir or os.environ.get("BYTEPS_FLIGHT_DIR") or \
        "./flight"
    return _recorder


def get_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, key: int = 0, rid: int = 0, detail: str = "") -> None:
    """The entry point of the fault paths' call sites."""
    _recorder.record(kind, key=key, rid=rid, detail=detail)


def dump(path: Optional[str] = None, reason: str = "manual"
         ) -> Optional[str]:
    """Write the worker's events as JSON (the JAX dump's shape, with an
    empty server section) and return the path; None when the recorder is
    off or the file cannot be written. Never raises."""
    if not _recorder.enabled:
        return None
    events = _recorder.events()
    if path is None:
        path = os.path.join(_dump_dir, f"flight-{os.getpid()}.json")
    doc = {"reason": reason, "pid": os.getpid(),
           "recorded_at_monotonic_ns": time.monotonic_ns(),
           "worker": {"events": events, "stats": _recorder.snapshot()},
           "servers": [],
           "merged": [dict(e, source="worker") for e in events]}
    tmp = f"{path}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with _dump_mu:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            # whole or not at all: a reader never sees a half-written dump
            os.replace(tmp, path)
    except OSError:
        return None
    return path
