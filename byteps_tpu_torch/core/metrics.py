"""The metrics registry and the per-step pipeline profiler.

Port of byteps_tpu/core/metrics.py, the measurement plane that answers
"what is this step bound on?":

- ``MetricsRegistry``: process-wide monotonic ``Counter``s, ``Gauge``s
  (set directly, or read from a callback at snapshot time) and
  ``Histogram``s of 34 fixed log2 buckets, plus ``section``s collected
  live at snapshot time (the arena, the server stats, the fleet).
  Thread-safe; an instrument op is one lock and an integer update. With
  BYTEPS_METRICS=0 every instrument op is a flag check and a return.
- ``StepProfiler``: the PS train step opens a ``StepReport`` a step, the
  scheduler's stage threads feed it per-partition stage samples and wire
  spans, and ``end_step`` closes it into a ring of the last N reports,
  prices it on the efficiency ledger (``core/ledger.py``), runs the
  observers (the health plane, the ledger, the time-series plane) and,
  under BYTEPS_STALL_DIAG, logs ``classify_step``'s one-line verdict.
- exposition: ``prometheus_text`` and ``start_http_server``, a stdlib
  ``/metrics`` endpoint on 127.0.0.1 (BYTEPS_METRICS_PORT).

The code is the JAX module's, so that one sequence of instrument
operations gives the same snapshot and the same Prometheus text in both
packages, and one table of reports the same verdicts.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StepReport", "StepProfiler", "classify_step", "server_attribution",
    "prometheus_text", "start_http_server",
]


# 34 log2 buckets in microseconds: bucket i counts samples with
# us.bit_length() == i, so the span runs 1us .. ~2.3 hours — every
# latency this pipeline can produce lands inside, and the bucket count
# is fixed so a histogram never allocates after construction.
HIST_BUCKETS = 34


class Counter:
    """Monotonic counter. ``inc`` is one lock + int add."""

    __slots__ = ("name", "_v", "_mu", "_reg")

    def __init__(self, name: str, reg: Optional["MetricsRegistry"] = None):
        self.name = name
        self._v = 0                    # guarded-by: _mu
        self._mu = threading.Lock()
        self._reg = reg

    def inc(self, n: int = 1) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        with self._mu:
            self._v += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._v


class Gauge:
    """Last-write-wins gauge; ``set_fn`` makes it lazily collected (the
    callback is read at snapshot/exposition time — how live structures
    like the staging arena surface without a write on their hot path)."""

    __slots__ = ("name", "_v", "_fn", "_mu", "_reg")

    def __init__(self, name: str, reg: Optional["MetricsRegistry"] = None):
        self.name = name
        self._v = 0.0                  # guarded-by: _mu
        self._fn: Optional[Callable[[], float]] = None  # guarded-by: _mu
        self._mu = threading.Lock()
        self._reg = reg

    def set(self, v: float) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        with self._mu:
            self._v = v

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._mu:
            self._fn = fn

    def set_max(self, v: float) -> None:
        """Ratchet: keep the max of all sets (peak gauges)."""
        if self._reg is not None and not self._reg.enabled:
            return
        with self._mu:
            if v > self._v:
                self._v = v

    @property
    def value(self) -> float:
        with self._mu:
            fn = self._fn
            if fn is None:
                return self._v
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 - a dead collector reads 0
            return 0.0


class Histogram:
    """Fixed-log2-bucket latency/size histogram.

    ``record(value)`` buckets by ``int(value).bit_length()`` — for
    latencies, record MICROSECONDS (``record_seconds`` converts). The
    bucket array is preallocated; the hot path is one lock, one
    bit_length, four int mutations. Percentiles come back as the upper
    bound of the covering bucket (log2 resolution — the stall detector
    needs "41ms vs 12ms", not nanosecond truth)."""

    __slots__ = ("name", "unit", "_counts", "_count", "_sum", "_min",
                 "_max", "_mu", "_reg")

    def __init__(self, name: str, unit: str = "us",
                 reg: Optional["MetricsRegistry"] = None):
        self.name = name
        self.unit = unit
        self._counts = [0] * HIST_BUCKETS  # guarded-by: _mu
        self._count = 0                    # guarded-by: _mu
        self._sum = 0                      # guarded-by: _mu
        self._min = None                   # guarded-by: _mu
        self._max = None                   # guarded-by: _mu
        self._mu = threading.Lock()
        self._reg = reg

    def record(self, value: float) -> None:
        if self._reg is not None and not self._reg.enabled:
            return
        v = int(value)
        if v < 0:
            v = 0
        b = v.bit_length()
        if b >= HIST_BUCKETS:
            b = HIST_BUCKETS - 1
        with self._mu:
            self._counts[b] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def record_seconds(self, seconds: float) -> None:
        self.record(seconds * 1e6)

    def percentile(self, p: float) -> Optional[float]:
        """Upper bucket bound covering the p-quantile (0 < p <= 1)."""
        with self._mu:
            counts, count, mx = list(self._counts), self._count, self._max
        return self._pct_from(counts, count, mx, p)

    def snapshot(self) -> dict:
        with self._mu:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            counts = list(self._counts)
        out = {"count": count, "sum": total, "min": mn, "max": mx,
               "unit": self.unit, "buckets": counts}
        for p, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[key] = self._pct_from(counts, count, mx, p)
        return out

    @staticmethod
    def _pct_from(counts, count, mx, p) -> Optional[float]:
        if count == 0:
            return None
        target = p * count
        seen = 0
        for b, c in enumerate(counts):
            seen += c
            if seen >= target:
                return float((1 << b) - 1) if b else 0.0
        return float(mx)


class MetricsRegistry:
    """Process-wide instrument table. Instrument lookup takes the
    registry lock (call sites cache their references for hot paths);
    instrument ops take only the instrument's own lock."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._mu = threading.Lock()
        self._counters: Dict[str, Counter] = {}    # guarded-by: _mu
        self._gauges: Dict[str, Gauge] = {}        # guarded-by: _mu
        self._hists: Dict[str, Histogram] = {}     # guarded-by: _mu
        # sections collected live at snapshot time (name -> dict fn):
        # how the staging arena / export counters surface without a
        # registry write on their own hot paths
        # guarded-by: _mu
        self._sections: Dict[str, Callable[[], dict]] = {}

    # -- instrument get-or-create ------------------------------------- #

    def counter(self, name: str) -> Counter:
        with self._mu:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._mu:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self)
            return g

    def histogram(self, name: str, unit: str = "us") -> Histogram:
        with self._mu:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, unit, self)
            return h

    def section(self, name: str, collect: Callable[[], dict]) -> None:
        """Register a live-collected snapshot section (e.g. "arena")."""
        with self._mu:
            self._sections[name] = collect

    def instruments(self) -> tuple:
        """(counters, gauges) instrument-table copies — the time-series
        recorder's lightweight per-step sample surface: unlike
        ``snapshot()`` it runs NO section collectors (the fleet section
        does wire RPCs; a per-step sweep must never pay that)."""
        with self._mu:
            return dict(self._counters), dict(self._gauges)

    # -- exposition ---------------------------------------------------- #

    def snapshot(self) -> dict:
        with self._mu:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            sections = dict(self._sections)
        out = {
            "enabled": self.enabled,
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {n: g.value for n, g in gauges.items()},
            "histograms": {n: h.snapshot() for n, h in hists.items()},
        }
        for name, collect in sections.items():
            try:
                out[name] = collect()
            except Exception:  # noqa: BLE001 - a dead section reads {}
                out[name] = {}
        return out


# --------------------------------------------------------------------- #
# per-step pipeline profiler
# --------------------------------------------------------------------- #


@dataclasses.dataclass
class StepReport:
    """One PS train step's pipeline accounting.

    Stage walls are milliseconds. ``compute_ms`` covers the step's start
    through the last gradient leaf leaving the card (the copy of the
    last leaf to the host has completed, not merely been queued);
    ``drain_ms`` is
    the completion-ordered PULL→H2D→UPDATE loop; ``tail_ms`` everything
    after the last pull landed (fused apply barrier / lease release /
    merge). Stage percentile fields aggregate the scheduler's per-task
    samples for THIS step only."""

    step: int = 0
    wall_ms: float = 0.0
    compute_ms: float = 0.0
    drain_ms: float = 0.0
    tail_ms: float = 0.0
    ttfp_ms: Optional[float] = None
    streamed_leaves: int = 0
    fallback_leaves: int = 0
    queue_depth_peak: int = 0
    credit_stalls: int = 0
    push_p95_ms: Optional[float] = None
    pull_p95_ms: Optional[float] = None
    compress_p95_ms: Optional[float] = None
    h2d_update_p95_ms: Optional[float] = None
    pull_wait_ms: float = 0.0  # time the drain sat blocked on ready.get
    # wall spent issuing the post-update all-gathers that rebuild
    # replicated params from shard updates (locality-sharded export;
    # dispatch wall — the gathers themselves complete asynchronously
    # on the card, overlapped with later pulls). 0.0 when no leaf sharded.
    allgather_ms: float = 0.0
    # Server attribution (fleet observability plane): per-stage server
    # walls accrued DURING this step, summed over the fleet — deltas of
    # the per-stage counters the StepProfiler's fleet probe snapshots
    # at the step boundaries (in-process mirror or the STATS_PULL wire
    # op). Same units as pull_total_ms (sums over this step's
    # requests), so classify_step can split a PULL-bound verdict into
    # queue-wait-bound / fold-bound / wire-bound. None = no probe (no
    # fleet reachable), never silently 0.
    pull_total_ms: Optional[float] = None
    server_recv_ms: Optional[float] = None
    server_queue_ms: Optional[float] = None
    server_fold_ms: Optional[float] = None
    server_reply_ms: Optional[float] = None
    # Step efficiency ledger (core/ledger.py): the step priced against
    # its registered cost model. achieved_flops = cost-model FLOPs /
    # wall; mfu = achieved / device-kind peak (BYTEPS_PEAK_FLOPS
    # overrides); roofline_frac = the cost model's attainable-MFU bound
    # (arithmetic intensity × bandwidth, capped at peak); overlap_frac
    # = fraction of this step's wire time hidden under compute (union
    # of the scheduler's wire spans ∩ the compute interval);
    # wire_efficiency = ideal exchange bytes ÷ actual wire bytes
    # (wire_bytes, the step's counter delta). All None when the ledger
    # is off (BYTEPS_LEDGER=0) or its input is absent — never a silent
    # zero.
    achieved_flops: Optional[float] = None
    mfu: Optional[float] = None
    roofline_frac: Optional[float] = None
    overlap_frac: Optional[float] = None
    wire_efficiency: Optional[float] = None
    wire_bytes: Optional[int] = None
    # Training-health plane (core/health.py, BYTEPS_HEALTH): per-step
    # numerics statistics tapped off the sharded-apply drain —
    # grad_norm is the global post-aggregation gradient norm,
    # update_ratio_p95 the p95 per-leaf ||g||/||p|| trust-ratio proxy,
    # nonfinite_leaves how many leaves carried NaN/Inf, and
    # fidelity_drift the worst server-vs-worker aggregate-norm
    # divergence over lossy-codec leaves. health_flags is the
    # detector's verdict for this step (tuple of anomaly-class names,
    # () = checked and healthy), stamped by the HealthPlane observer —
    # the codec plane's numerics veto reads it. All None when the
    # health pass is off — never a silent 0.
    grad_norm: Optional[float] = None
    update_ratio_p95: Optional[float] = None
    nonfinite_leaves: Optional[int] = None
    fidelity_drift: Optional[float] = None
    health_flags: Optional[tuple] = None
    # Per-stripe lane attribution (the JAX package's striped wire): the
    # per-lane data byte shares of the step; classify_step names a lane
    # whose share skews past 2x the median. The port has no lane probe
    # (the stripe counters' per-step sweep is not ported): None here,
    # kept so that a report reads alike in both packages.
    lane_count: Optional[int] = None
    lane_share_max: Optional[float] = None
    lane_share_min: Optional[float] = None
    lane_share_median: Optional[float] = None
    lane_max_id: Optional[int] = None
    lane_min_id: Optional[int] = None
    lane_server: Optional[int] = None
    lane_bytes: Optional[tuple] = None
    # Bounded-staleness carry attribution (the cross-barrier window,
    # tapped by training/train.py): carried_leaves = stale leaves drained
    # from earlier rounds this step, carry_drain_ms = wall spent
    # draining that carried tail, staleness_lag = max effective
    # staleness (in steps) among the drained carries, and window_depth
    # = leaves still deferred in the window when the step closed. None
    # when the cross-barrier window is off — never a silent 0.
    carried_leaves: Optional[int] = None
    carry_drain_ms: Optional[float] = None
    staleness_lag: Optional[int] = None
    window_depth: Optional[int] = None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _p95(samples: List[float]) -> Optional[float]:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.95 * len(s)))]


def server_attribution(r: StepReport) -> Optional[tuple]:
    """Split a step's PULL time across the server's stages. Returns
    ``(sub_verdict, queue_ms, fold_ms, wire_ms)`` or None when the
    probe didn't run.

    The arithmetic: the worker's PULL samples measure submit →
    completion per partition, so their SUM is comparable with the
    fleet's per-stage wall DELTAS over the same step. ``wire`` is
    everything the server didn't account for as queue-wait or fold —
    payload recv, the aggregate reply send (both inflate under a
    throttled/slow transport) and true time on the network:
    ``wire = recv + reply + max(0, pull_total - all server stages)``.
    Whichever of queue-wait / fold / wire dominates names the
    sub-verdict — the exact sensor an autoscaler needs ("queue-wait-
    bound: add a server" vs "wire-bound: the network is the wall")."""
    if r.server_queue_ms is None or r.pull_total_ms is None:
        return None
    recv = r.server_recv_ms or 0.0
    reply = r.server_reply_ms or 0.0
    queue = r.server_queue_ms or 0.0
    fold = r.server_fold_ms or 0.0
    residual = max(0.0, r.pull_total_ms - (recv + queue + fold + reply))
    wire = recv + reply + residual
    sub = max((("queue-wait", queue), ("fold", fold), ("wire", wire)),
              key=lambda kv: kv[1])
    return f"{sub[0]}-bound", queue, fold, wire


def classify_step(r: StepReport) -> str:
    """Straggler/stall diagnosis: name the stage the step is bound on.

    The comparison is stage p95 (a single slow partition decides the
    step wall under completion-ordered draining) against the compute
    wall; the PULL signal also considers the drain's aggregate blocked
    time (``pull_wait_ms`` — many medium pulls serializing reads as a
    stall even when no single partition's p95 does). Queue pressure
    annotates the verdict. Returns e.g. ``"PULL-bound: pull p95 41.0ms
    vs compute 12.0ms; queue depth peaked 37"``.

    With the fleet probe's server attribution present, a PULL-bound
    verdict additionally names the server stage that ate the time:
    ``"PULL-bound/queue-wait-bound: ... (server queue-wait 30.1ms,
    fold 4.2ms, wire 6.7ms)"`` — the split an autoscaler consumes."""
    pull_sig = max(r.pull_p95_ms or 0.0, r.pull_wait_ms or 0.0)
    candidates = {
        "COMPUTE": r.compute_ms,
        "PUSH": r.push_p95_ms or 0.0,
        "PULL": pull_sig,
        "COMPRESS": r.compress_p95_ms or 0.0,
        "UPDATE": r.h2d_update_p95_ms or 0.0,
    }
    bound = max(candidates, key=lambda k: candidates[k])
    if bound == "COMPUTE":
        label = "compute wall"
    elif bound == "PULL" and pull_sig != (r.pull_p95_ms or 0.0):
        label = "pull wait"  # the aggregate drain block decided it
    else:
        label = f"{bound.lower()} p95"
    attribution = server_attribution(r) if bound == "PULL" else None
    if attribution is not None:
        parts = [f"{bound}-bound/{attribution[0]}: "
                 f"{label} {candidates[bound]:.1f}ms"]
    else:
        parts = [f"{bound}-bound: {label} {candidates[bound]:.1f}ms"]
    if bound != "COMPUTE":
        parts.append(f"vs compute {r.compute_ms:.1f}ms")
    else:
        comm = max(candidates["PUSH"], candidates["PULL"])
        parts.append(f"vs comm p95 {comm:.1f}ms")
    if attribution is not None:
        _, queue, fold, wire = attribution
        parts.append(f"(server queue-wait {queue:.1f}ms, "
                     f"fold {fold:.1f}ms, wire {wire:.1f}ms)")
    msg = " ".join(parts)
    extras = []
    if r.queue_depth_peak:
        extras.append(f"queue depth peaked {r.queue_depth_peak}")
    if r.credit_stalls:
        extras.append(f"{r.credit_stalls} credit stalls")
    if r.ttfp_ms is not None:
        extras.append(f"ttfp {r.ttfp_ms:.1f}ms")
    if extras:
        msg += "; " + ", ".join(extras)
    # efficiency verdict (step efficiency ledger, core/ledger.py):
    # "MFU 0.31 of 0.58 roofline; overlap 62%; wire 1.9x ideal"
    effs = []
    if r.mfu is not None:
        e = f"MFU {r.mfu:.2f}"
        if r.roofline_frac:
            e += f" of {r.roofline_frac:.2f} roofline"
        effs.append(e)
    if r.overlap_frac is not None:
        effs.append(f"overlap {r.overlap_frac * 100:.0f}%")
    if r.wire_efficiency:
        effs.append(f"wire {1.0 / r.wire_efficiency:.1f}x ideal")
    if effs:
        msg += "; " + "; ".join(effs)
    # training-health verdict (core/health.py): "health: grad_norm
    # 0.031, update p95 2.1e-4" on a healthy step; anomalies upgrade it
    # to "HEALTH nonfinite,explode: 3 nonfinite leaves, ..."
    if r.grad_norm is not None or r.nonfinite_leaves:
        hp = []
        if r.nonfinite_leaves:
            hp.append(f"{r.nonfinite_leaves} nonfinite leaves")
        if r.grad_norm is not None:
            hp.append(f"grad_norm {r.grad_norm:.3g}")
        if r.update_ratio_p95 is not None:
            hp.append(f"update p95 {r.update_ratio_p95:.2g}")
        if r.fidelity_drift is not None:
            hp.append(f"drift {r.fidelity_drift * 100:.1f}%")
        if r.health_flags:
            msg += ("; HEALTH " + ",".join(r.health_flags) + ": "
                    + ", ".join(hp))
        else:
            msg += "; health: " + ", ".join(hp)
    # per-stripe lane-imbalance verdict (time-series plane): when one
    # data lane's stripe byte share skews past 2× the median, name the
    # SLOWEST (min-share) lane — under round-robin striping a slow lane
    # shows up as the one moving the fewest segment bytes. e.g.
    # "; LANE-IMBALANCE server 0 lane 3 slowest: share 4% (median 23%,
    # max 51% on lane 1)"
    if (r.lane_count and r.lane_count >= 2
            and r.lane_share_max is not None
            and r.lane_share_median is not None
            and r.lane_share_max > 2.0 * r.lane_share_median):
        msg += (f"; LANE-IMBALANCE server {r.lane_server} lane "
                f"{r.lane_min_id} slowest: share "
                f"{(r.lane_share_min or 0.0) * 100:.0f}% (median "
                f"{r.lane_share_median * 100:.0f}%, max "
                f"{r.lane_share_max * 100:.0f}% on lane {r.lane_max_id})")
    return msg


class _StepBuilder:
    """Mutable collection state for one in-flight step. Scheduler pool
    threads append stage samples concurrently with the train thread's
    phase marks; one lock serializes them (sample rate is per-partition,
    not per-byte — contention is negligible)."""

    __slots__ = ("step", "t0", "_mu", "stage_samples", "queue_peak",
                 "credit_stalls", "marks", "pull_wait_s", "fleet_base",
                 "wire_spans", "wire_base", "monolithic")

    def __init__(self, step: int):
        self.step = step
        self.t0 = time.perf_counter()
        # fleet per-stage counter snapshot at step start (train-thread
        # only, set by StepProfiler.begin_step); None = no probe
        self.fleet_base: Optional[Dict[str, int]] = None
        # wire byte-counter snapshot at step start (train-thread only,
        # set by StepProfiler.begin_step); None = no ledger
        self.wire_base: Optional[int] = None
        # reduced-shape round (device-compressed tier): compute and
        # wire are one monolithic helper, so export_done lands AFTER
        # the wire — every span would read as "hidden under compute"
        # and fabricate overlap_frac 1.0. Set by the train thread;
        # overlap then prices as None, like the tier's other fields.
        self.monolithic = False
        self._mu = threading.Lock()
        # stage samples / queue peak / stalls arrive from scheduler pool
        # threads; marks and pull_wait_s are train-thread-only by
        # contract (see class docstring), so they stay unguarded
        self.stage_samples: Dict[str, List[float]] = {}  # guarded-by: _mu
        self.queue_peak = 0                              # guarded-by: _mu
        self.credit_stalls = 0                           # guarded-by: _mu
        # wire exchange intervals relative to step start, fed by the
        # scheduler's completion callbacks — the ledger's overlap
        # timeline (core/ledger.py overlap_fraction)
        self.wire_spans: List[tuple] = []                # guarded-by: _mu
        self.marks: Dict[str, float] = {}
        self.pull_wait_s = 0.0

    def stage_sample(self, stage: str, seconds: float) -> None:
        with self._mu:
            self.stage_samples.setdefault(stage, []).append(seconds * 1e3)

    def wire_span(self, start: float, end: float) -> None:
        """One wire exchange's absolute (perf_counter) interval, stored
        relative to step start for the ledger's overlap accounting."""
        with self._mu:
            self.wire_spans.append((start - self.t0, end - self.t0))

    def queue_depth(self, depth: int) -> None:
        with self._mu:
            if depth > self.queue_peak:
                self.queue_peak = depth

    def credit_stall(self) -> None:
        with self._mu:
            self.credit_stalls += 1

    def mark(self, name: str) -> None:
        """Phase boundary relative to step start (train-thread only)."""
        self.marks[name] = time.perf_counter() - self.t0

    def add_pull_wait(self, seconds: float) -> None:
        self.pull_wait_s += seconds


class StepProfiler:
    """Assembles ``StepReport``s and keeps the last N in a ring.

    One step is active at a time (the PS train step is synchronous);
    scheduler threads read ``current()`` — samples that land between
    steps (async tails) are dropped, which is the honest choice: they
    belong to no step's critical path."""

    def __init__(self, window: int = 64, enabled: bool = True,
                 stall_diag: bool = False,
                 fleet_probe=None, ledger=None):
        import collections
        self.enabled = enabled
        self.stall_diag = stall_diag
        # step efficiency ledger (core/ledger.py): prices each finished
        # step (MFU/roofline/overlap/wire-efficiency) from its
        # registered cost model + the wire spans/byte deltas this
        # profiler collects. None (or disabled) = fields stay None.
        self._ledger = ledger if (ledger is not None
                                  and getattr(ledger, "enabled", False)) \
            else None
        # () -> {"recv_ns", "queue_ns", "fold_ns", "reply_ns"} summed
        # over the reachable fleet (in-process mirror or STATS_PULL),
        # or None. Snapshotted at both step boundaries; the deltas are
        # the StepReport's server-attribution fields. Wired by
        # core/state.py; None = no attribution (fields stay None).
        self._fleet_probe = fleet_probe
        # end_step's probe doubles as the NEXT step's baseline (steps
        # are contiguous), so a remote fleet pays ONE probe sweep per
        # step, not two; train-thread only, like the builder marks
        self._probe_cache: Optional[dict] = None
        self._mu = threading.Lock()
        self._reports = collections.deque(maxlen=max(1, window))  # guarded-by: _mu
        self._current: Optional[_StepBuilder] = None  # guarded-by: _mu
        self._step_no = 0                             # guarded-by: _mu
        # step-boundary observers (the autoscaler plane's sensor tap):
        # called with each finished StepReport ON THE TRAIN THREAD at
        # end_step, after the report is in the ring — the one place a
        # control loop may safely mutate the routing table (the elastic
        # thread contract, core/elastic.py)
        self._observers: List = []                    # guarded-by: _mu

    def _probe_fleet(self) -> Optional[dict]:
        if self._fleet_probe is None:
            return None
        try:
            return self._fleet_probe()
        except Exception:  # noqa: BLE001 - attribution is best-effort
            return None

    def begin_step(self) -> Optional[_StepBuilder]:
        if not self.enabled:
            return None
        with self._mu:
            self._step_no += 1
            self._current = _StepBuilder(self._step_no)
            cur = self._current
        # outside _mu: the probe may do a small wire RPC; the previous
        # end_step's reading is this step's baseline when available
        cur.fleet_base = self._probe_cache
        self._probe_cache = None
        if cur.fleet_base is None:
            cur.fleet_base = self._probe_fleet()
        if self._ledger is not None:
            try:
                cur.wire_base = self._ledger.wire_bytes_total()
            except Exception:  # noqa: BLE001 - pricing is best-effort
                cur.wire_base = None
        return cur

    def current(self) -> Optional[_StepBuilder]:
        # racy read by design: scheduler threads sample whatever step is
        # open right now; a stale builder reference still collects into
        # a consistent (that step's) report — taking the lock here would
        # put it on every stage completion for no correctness gain
        return self._current  # bps-lint: disable=guarded-by

    def end_step(self, b: Optional[_StepBuilder], ttfp_ms=None,
                 streamed: int = 0, fallback: int = 0,
                 health: Optional[dict] = None,
                 xb: Optional[dict] = None) -> Optional[StepReport]:
        if b is None:
            return None
        wall = (time.perf_counter() - b.t0) * 1e3
        with b._mu:
            samples = {k: list(v) for k, v in b.stage_samples.items()}
            queue_peak, stalls = b.queue_peak, b.credit_stalls
        # server attribution: delta the fleet's per-stage counters over
        # the step (ns -> ms); pull_total is the comparable worker-side
        # sum (each PULL sample is one partition's submit→completion)
        srv = {}
        if b.fleet_base is not None:
            end = self._probe_fleet()
            self._probe_cache = end  # next begin_step's baseline
            if end is not None:
                srv = {k: max(0, end.get(k, 0) - b.fleet_base.get(k, 0))
                       / 1e6
                       for k in ("recv_ns", "queue_ns", "fold_ns",
                                 "reply_ns")}
        pull_total = sum(samples.get("PULL", [])) if srv else None
        # step efficiency ledger: price the step from the registered
        # cost model + this step's wire spans and wire byte delta
        eff: dict = {}
        if self._ledger is not None:
            with b._mu:
                spans = [] if b.monolithic else list(b.wire_spans)
            try:
                eff = self._ledger.step_efficiency(
                    wall_s=wall / 1e3,
                    compute_end_s=b.marks.get("export_done", 0.0),
                    wire_spans=spans, wire_base=b.wire_base) or {}
            except Exception:  # noqa: BLE001 - pricing is best-effort
                eff = {}
        r = StepReport(
            step=b.step,
            wall_ms=wall,
            compute_ms=b.marks.get("export_done", 0.0) * 1e3,
            drain_ms=(b.marks.get("drain_done", 0.0)
                      - b.marks.get("export_done", 0.0)) * 1e3,
            tail_ms=wall - b.marks.get("drain_done", 0.0) * 1e3
            if "drain_done" in b.marks else 0.0,
            ttfp_ms=ttfp_ms,
            streamed_leaves=streamed,
            fallback_leaves=fallback,
            queue_depth_peak=queue_peak,
            credit_stalls=stalls,
            push_p95_ms=_p95(samples.get("PUSH", [])),
            pull_p95_ms=_p95(samples.get("PULL", [])),
            compress_p95_ms=_p95(samples.get("COMPRESS", [])
                                 + samples.get("DECOMPRESS", [])),
            h2d_update_p95_ms=_p95(samples.get("H2D_UPDATE", [])),
            pull_wait_ms=b.pull_wait_s * 1e3,
            allgather_ms=sum(samples.get("ALLGATHER", [])),
            pull_total_ms=pull_total,
            server_recv_ms=srv.get("recv_ns"),
            server_queue_ms=srv.get("queue_ns"),
            server_fold_ms=srv.get("fold_ns"),
            server_reply_ms=srv.get("reply_ns"),
            achieved_flops=eff.get("achieved_flops"),
            mfu=eff.get("mfu"),
            roofline_frac=eff.get("roofline_frac"),
            overlap_frac=eff.get("overlap_frac"),
            wire_efficiency=eff.get("wire_efficiency"),
            wire_bytes=eff.get("wire_bytes"),
            grad_norm=(health or {}).get("grad_norm"),
            update_ratio_p95=(health or {}).get("update_ratio_p95"),
            nonfinite_leaves=(health or {}).get("nonfinite_leaves"),
            fidelity_drift=(health or {}).get("fidelity_drift"),
            carried_leaves=(xb or {}).get("carried_leaves"),
            carry_drain_ms=(xb or {}).get("carry_drain_ms"),
            staleness_lag=(xb or {}).get("staleness_lag"),
            window_depth=(xb or {}).get("window_depth"),
        )
        with self._mu:
            self._reports.append(r)
            if self._current is b:
                self._current = None
            observers = list(self._observers)
        for fn in observers:
            try:
                fn(r)
            except Exception:  # noqa: BLE001 - observers must not kill
                from ..utils.logging import log  # the step
                log.exception("step observer raised")
        if self.stall_diag:
            from ..utils.logging import log
            log.info("step %d [%.1fms] %s", r.step, r.wall_ms,
                     classify_step(r))
        return r

    def add_observer(self, fn) -> None:
        """Register a step-boundary observer: ``fn(report)`` runs on
        the train thread after every finished step (see _observers)."""
        with self._mu:
            self._observers.append(fn)

    def reports(self) -> List[StepReport]:
        with self._mu:
            return list(self._reports)

    def last(self) -> Optional[StepReport]:
        with self._mu:
            return self._reports[-1] if self._reports else None

    def snapshot(self) -> dict:
        with self._mu:
            reports = list(self._reports)
            window = self._reports.maxlen
        out = {"window": window, "count": len(reports),
               "last": reports[-1].as_dict() if reports else None}
        if reports:
            out["last_diagnosis"] = classify_step(reports[-1])
        return out


# --------------------------------------------------------------------- #
# Prometheus text exposition (stdlib only)
# --------------------------------------------------------------------- #


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    n = "".join(out)
    if n and n[0].isdigit():
        n = "_" + n
    return "byteps_" + n


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4.
    Histograms emit cumulative ``_bucket{le=...}`` series with the
    log2 upper bounds, plus ``_sum``/``_count``; snapshot sections
    flatten to gauges (non-numeric values are skipped)."""
    snap = registry.snapshot()
    lines: List[str] = []
    for name, v in sorted(snap["counters"].items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    for name, v in sorted(snap["gauges"].items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    for name, h in sorted(snap["histograms"].items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for b, c in enumerate(h["buckets"]):
            if c == 0:
                continue
            cum += c
            le = (1 << b) - 1
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{pn}_sum {h['sum']}")
        lines.append(f"{pn}_count {h['count']}")
    # fleet section: per-server sub-dicts export as ONE labeled series
    # per metric (`byteps_fleet_fold_ms{server="0"} ...`) from the same
    # snapshot path as bps.get_fleet_metrics() — scraping the endpoint
    # and calling the API can never disagree about the fleet
    fleet = snap.get("fleet")
    if isinstance(fleet, dict):
        for metric in sorted({k for s in fleet.get("server", {}).values()
                              if isinstance(s, dict) for k in s}):
            pn = _prom_name(f"fleet_{metric}")
            lines.append(f"# TYPE {pn} gauge")
            for idx, per in sorted(fleet.get("server", {}).items()):
                v = per.get(metric) if isinstance(per, dict) else None
                if isinstance(v, bool):
                    v = int(v)
                if isinstance(v, (int, float)):
                    lines.append(f'{pn}{{server="{idx}"}} {v}')
    for section, values in snap.items():
        if section in ("enabled", "counters", "gauges", "histograms",
                       "steps"):
            continue
        if not isinstance(values, dict):
            continue
        for k, v in sorted(values.items()):
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                continue
            pn = _prom_name(f"{section}_{k}")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {v}")
    return "\n".join(lines) + "\n"


def start_http_server(registry: MetricsRegistry, port: int,
                      snapshot_fn: Optional[Callable[[], dict]] = None):
    """Serve ``/metrics`` (Prometheus text) and ``/`` (JSON snapshot)
    on a daemon thread. Stdlib only. ``registry`` may be the registry
    itself or a zero-arg callable returning it (resolved per request,
    so a re-init that replaces the registry keeps the endpoint live).
    Returns the server; call ``.shutdown()`` + ``.server_close()`` to
    stop (GlobalState.shutdown does). Binds 127.0.0.1 — scrape-proxy or
    port-forward to expose."""
    import http.server
    import json

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib API
            try:
                reg = registry() if callable(registry) else registry
                if self.path.startswith("/metrics"):
                    body = prometheus_text(reg).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    snap = snapshot_fn() if snapshot_fn \
                        else reg.snapshot()
                    body = json.dumps(snap, default=str).encode()
                    ctype = "application/json"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except BrokenPipeError:
                pass

        def log_message(self, *args):  # silence per-request stderr
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever,
                         name="bps-metrics-http", daemon=True)
    t.start()
    return server
