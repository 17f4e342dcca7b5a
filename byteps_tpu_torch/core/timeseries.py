"""The time-series plane: the bounded per-step history of every signal.

Port of byteps_tpu/core/timeseries.py. ``TimeSeriesPlane`` rides
``StepProfiler.add_observer``: one sweep per finished step, on the train
thread. It is clockless, so every series is indexed by step number,
never by wall time, and two runs over the same reports give the same
series byte for byte. A sweep over its time budget three times running
trips a one-way breaker that turns the plane off for the lifecycle, with
one log line.

Each step it samples, into fixed rings of BYTEPS_TS_POINTS points
(BYTEPS_TIMESERIES=0 turns the plane off): the StepReport's scalar
fields (``_TS_STEP_FIELDS``, as ``step/<field>``; a None is skipped, not
recorded as 0), the per-lane stripe bytes of ``StepReport.lane_bytes``,
and the registry's counter deltas and gauge values (from
``MetricsRegistry.instruments()``, never ``snapshot()``, whose sections
may do wire round trips).

Read by ``get_timeseries()`` (the whole rings), the ``timeseries``
section of ``get_metrics()`` (bounded tails) and ``dump_jsonl``, which
the SIGTERM hook chain runs first (time series, then the perf archive,
then the flight dump) and ``shutdown()`` runs too.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["TimeSeriesPlane", "_TS_STEP_FIELDS"]

# StepReport fields sampled into per-step series, one series per name.
# Append-only manifest; a test holds every name to a StepReport field
# (a renamed field would silently kill its series). None values are
# SKIPPED, not recorded as 0: a series only carries steps where the
# signal existed.
_TS_STEP_FIELDS = (
    "wall_ms", "compute_ms", "drain_ms", "tail_ms", "pull_wait_ms",
    "queue_depth_peak", "credit_stalls", "pull_total_ms",
    "server_queue_ms", "server_fold_ms", "mfu", "overlap_frac",
    "wire_efficiency", "wire_bytes", "grad_norm",
    "lane_share_max", "lane_share_min",
    "carried_leaves", "carry_drain_ms", "staleness_lag", "window_depth",
)

# sweep budget before the one-way breaker trips: generous against real
# sweeps (tens of microseconds) but a hung gauge callback or a runaway
# series population gets three strikes, then the plane goes dark
_BREAKER_BUDGET_S = 0.050
_BREAKER_STRIKES = 3


class _Series:
    """One signal's fixed ring: preallocated (step, value) columns,
    drop-oldest. Steady-state ``add`` allocates nothing."""

    __slots__ = ("steps", "values", "w", "cap")

    def __init__(self, cap: int):
        self.cap = cap
        self.steps = [0] * cap
        self.values = [0.0] * cap
        self.w = 0  # total points ever written

    def add(self, step: int, value: float) -> None:
        i = self.w % self.cap
        self.steps[i] = step
        self.values[i] = value
        self.w += 1

    def tail(self, n: Optional[int] = None) -> tuple:
        """(steps, values) oldest-first, last ``n`` points (all
        retained points when n is None)."""
        count = min(self.w, self.cap)
        if n is not None:
            count = min(count, int(n))
        start = self.w - count
        return ([self.steps[(start + i) % self.cap]
                 for i in range(count)],
                [self.values[(start + i) % self.cap]
                 for i in range(count)])


class TimeSeriesPlane:
    """The per-step recorder. ``observe`` is the StepProfiler observer
    (train thread); ``snapshot``/``series``/``dump_jsonl`` may be
    called from any thread (HTTP exposition, SIGTERM handler) — one
    lock serializes them, and the dump path uses a BOUNDED acquire
    because a signal may land on the very thread holding it."""

    # series-count ceiling: a runaway key population (one counter per
    # tensor name, say) must not grow memory without bound; new names
    # beyond the cap are counted, not recorded
    MAX_SERIES = 512

    def __init__(self, points: int = 512, enabled: bool = True,
                 registry=None, dump_dir: str = "./flight"):
        self.enabled = enabled
        self.points = max(16, int(points))
        self._registry = registry
        # SIGTERM/shutdown artifacts land beside the flight record by
        # default (the two dumps narrate the same death)
        self.dump_dir = dump_dir
        self._mu = threading.Lock()
        self._series: Dict[str, _Series] = {}  # guarded-by: _mu
        self._counter_base: Dict[str, int] = {}  # guarded-by: _mu
        self._steps = 0        # guarded-by: _mu (observe sweeps done)
        self._dropped = 0      # guarded-by: _mu (series past the cap)
        self._tripped = False  # guarded-by: _mu (one-way breaker)
        self._strikes = 0      # guarded-by: _mu

    # -- record path (train thread) ----------------------------------- #

    def _get_locked(self, name: str) -> Optional[_Series]:
        s = self._series.get(name)
        if s is None:
            if len(self._series) >= self.MAX_SERIES:
                self._dropped += 1
                return None
            s = self._series[name] = _Series(self.points)
        return s

    def _put_locked(self, name: str, step: int, value) -> None:
        # None values are skipped by the call sites
        s = self._get_locked(name)
        if s is not None:
            s.add(step, float(value))

    def observe(self, report) -> None:
        """The StepProfiler observer: one sweep per finished step.
        Clockless — nothing sampled here reads a wall clock; the
        breaker's own timing gates only WHETHER future sweeps run,
        never what lands in a series."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        step = int(getattr(report, "step", 0))
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        if self._registry is not None:
            try:
                ctab, gtab = self._registry.instruments()
                # instrument reads take each instrument's own lock;
                # done OUTSIDE _mu so a concurrent snapshot never
                # deadlocks against an instrument op
                counters = {n: c.value for n, c in ctab.items()}
                gauges = {n: g.value for n, g in gtab.items()}
            except Exception:  # noqa: BLE001 - sampling is best-effort
                counters, gauges = {}, {}
        with self._mu:
            if self._tripped:
                return
            self._steps += 1
            for name in _TS_STEP_FIELDS:
                v = getattr(report, name, None)
                if v is not None:
                    self._put_locked(f"step/{name}", step, v)
            lane_bytes = getattr(report, "lane_bytes", None) or ()
            for srv, lane, delta in lane_bytes:
                self._put_locked(f"stripe/s{srv}/lane{lane}/seg_bytes",
                                 step, delta)
            for name, v in counters.items():
                base = self._counter_base.get(name)
                self._counter_base[name] = v
                if base is not None and v >= base:
                    self._put_locked(f"counter/{name}", step, v - base)
            for name, v in gauges.items():
                self._put_locked(f"gauge/{name}", step, v)
            # breaker accounting: three consecutive over-budget sweeps
            # trip the plane one-way (same discipline as the fleet
            # section's pull breaker — one log line, then silence)
            if time.perf_counter() - t0 > _BREAKER_BUDGET_S:
                self._strikes += 1
                if self._strikes >= _BREAKER_STRIKES:
                    self._tripped = True
                    from ..utils.logging import log
                    log.warning(
                        "timeseries breaker tripped: %d consecutive "
                        "sweeps over %.0fms — recorder disabled for "
                        "this lifecycle", self._strikes,
                        _BREAKER_BUDGET_S * 1e3)
            else:
                self._strikes = 0

    # -- read surfaces (any thread) ----------------------------------- #

    def series(self, prefix: str = "",
               tail: Optional[int] = None) -> Dict[str, dict]:
        """Full (or ``tail``-bounded) rings as
        ``{name: {"steps": [...], "values": [...]}}``, optionally
        filtered by name prefix — the ``get_timeseries()`` body."""
        with self._mu:
            names = [n for n in self._series if n.startswith(prefix)]
            out = {}
            for n in names:
                steps, values = self._series[n].tail(tail)
                out[n] = {"steps": steps, "values": values}
        return out

    def snapshot(self, tail: int = 64) -> dict:
        """The ``timeseries`` section of ``get_metrics()``: fixed meta
        keys plus bounded series tails, the same from the local mirror
        or the HTTP ``/`` snapshot."""
        with self._mu:
            meta = {
                "enabled": self.enabled,
                "points": self.points,
                "steps": self._steps,
                "series_count": len(self._series),
                "dropped_series": self._dropped,
                "breaker_tripped": self._tripped,
            }
        meta["series"] = self.series(tail=tail)
        return meta

    def _dump_lines_locked(self, reason: str) -> Optional[List[str]]:
        if not self._series:
            return None
        lines = [json.dumps({
            "kind": "timeseries", "reason": reason,
            "pid": os.getpid(), "points": self.points,
            "steps": self._steps,
            "series_count": len(self._series),
            "dropped_series": self._dropped,
        })]
        for name in sorted(self._series):
            steps, values = self._series[name].tail()
            lines.append(json.dumps(
                {"name": name, "steps": steps, "values": values}))
        return lines

    def dump_jsonl(self, path: Optional[str] = None,
                   reason: str = "manual",
                   lock_timeout: Optional[float] = None
                   ) -> Optional[str]:
        """Write every series as JSONL (one header line, then one line
        per series) and return the path; None when the plane is off or
        empty. ``lock_timeout`` bounds the mutex acquire for the
        SIGTERM path — the signal may land on the thread that holds
        ``_mu`` mid-sweep, and a dump that deadlocks the handler is
        worse than a dump that skips (as ``PerfArchive.flush``)."""
        if not self.enabled:
            return None
        if lock_timeout is not None:
            if not self._mu.acquire(timeout=lock_timeout):
                return None
        else:
            self._mu.acquire()
        try:
            lines = self._dump_lines_locked(reason)
        finally:
            self._mu.release()
        if lines is None:
            return None
        out_path = path
        if out_path is None:
            out_path = os.path.join(self.dump_dir,
                                    f"timeseries-{os.getpid()}.jsonl")
        parent = os.path.dirname(os.path.abspath(out_path))
        try:
            os.makedirs(parent, exist_ok=True)
            with open(out_path, "w") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            return None
        return out_path

    def term_dump(self) -> None:
        """The SIGTERM term-hook body (flight.add_term_hook, pinned at
        TERM_ORDER_TIMESERIES so the artifact lands before the perf
        archive flushes and the flight record dumps)."""
        self.dump_jsonl(reason="SIGTERM", lock_timeout=1.0)
