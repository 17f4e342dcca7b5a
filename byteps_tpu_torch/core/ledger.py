"""The step efficiency ledger: the measurement plane's pricing layer.

Port of byteps_tpu/core/ledger.py. Three coupled pieces:

- **The cost model.** Once per plan (the gradient tree's shapes) the
  train step counts the FLOPs of its forward and backward by the
  formulas of ``torch.utils.flop_counter.FlopCounterMode``
  (``count_flops``, ``utils/flops.py``; the JAX package asks XLA's cost
  analysis instead), with what the card's hand-written kernels report
  (the flash forward is a ctypes launch no dispatch mode sees), and
  registers it here with
  the plan's ideal exchange bytes (each gradient leaf once each way).
  ``source`` says ``"flop_counter"``. ``StepProfiler`` then prices every
  finished step: ``achieved_flops``, ``mfu`` against the card's peak
  (``detect_peak``: the longest matching row of ``PEAK_TABLE`` for
  ``torch.cuda.get_device_name()``, or BYTEPS_PEAK_FLOPS),
  ``overlap_frac`` (the share of the wire time under compute, from the
  scheduler's wire spans) and ``wire_efficiency`` (ideal exchange bytes
  over the step's wire bytes).
- **The perf archive.** BYTEPS_PERF_ARCHIVE=<dir> appends one JSONL
  record a step, buffered and written every BYTEPS_PERF_FLUSH_STEPS, at
  ``shutdown()`` and on SIGTERM.
- **Efficiency-drop events.** When ``mfu`` or ``overlap_frac`` falls
  more than BYTEPS_EFF_DROP_FRAC below its trailing median, an
  ``efficiency_drop`` event lands in the flight recorder.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.logging import log

__all__ = [
    "PEAK_TABLE", "detect_peak", "device_kind", "count_flops",
    "overlap_fraction", "roofline_fraction",
    "PerfArchive", "EfficiencyLedger", "register_ledger_metrics",
]


# bf16 dense peak FLOP/s and memory GB/s per device kind, matched as
# lowercase substrings of the device's name LONGEST FIRST (so "h100
# 80gb hbm3" wins over a shorter row, and "v5 lite" over "v5"). The
# H100 rows are NVIDIA's published dense bf16 and memory figures for
# the SXM (80GB HBM3) and PCIe cards; the TPU rows are the JAX
# package's table, kept so that both packages read a TPU's name alike.
# The CPU row below is a NOMINAL anchor: absolute CPU MFU means nothing,
# but a stable denominator keeps the per-step series comparable; set
# BYTEPS_PEAK_FLOPS when an absolute number matters.
PEAK_TABLE: Tuple[Tuple[str, float, float], ...] = (
    ("h100 80gb hbm3", 989e12, 3350.0),
    ("h100 pcie", 756e12, 2000.0),
    ("v6 lite", 918e12, 1640.0),
    ("v6e", 918e12, 1640.0),
    ("v5 lite", 197e12, 819.0),
    ("v5e", 197e12, 819.0),
    ("v5p", 459e12, 2765.0),
    ("v4", 275e12, 1228.0),
    ("v3", 123e12, 900.0),
    ("v2", 45e12, 700.0),
)
# nominal per-core CPU fp32 peak (≈3 GHz × 2×8-lane FMA) and a flat
# host memory bandwidth — the loopback-CI denominator (see PEAK_TABLE)
_CPU_FLOPS_PER_CORE = 5e10
_CPU_BW_GBPS = 20.0
# last-resort default when even the platform is unknown
_DEFAULT_PEAK = (1e12, 100.0)


def detect_peak(device_kind: str = "",
                env=os.environ) -> Tuple[float, float, str]:
    """``(peak_flops, peak_bw_gbps, source)`` for a device kind.

    ``BYTEPS_PEAK_FLOPS`` / ``BYTEPS_PEAK_BW_GBPS`` (> 0) override the
    table per component (source ``env``); otherwise the longest
    matching PEAK_TABLE row wins (source ``table``), then the CPU
    nominal (source ``cpu-nominal``), then a documented default
    (source ``default``).
    """
    kind = (device_kind or "").lower()
    flops = bw = None
    source = "default"
    for pat, f, b in sorted(PEAK_TABLE, key=lambda r: -len(r[0])):
        if pat in kind:
            flops, bw, source = f, b, "table"
            break
    if flops is None and "cpu" in kind:
        flops = (os.cpu_count() or 1) * _CPU_FLOPS_PER_CORE
        bw, source = _CPU_BW_GBPS, "cpu-nominal"
    if flops is None:
        flops, bw = _DEFAULT_PEAK
    try:
        ov = float(env.get("BYTEPS_PEAK_FLOPS", "0") or "0")
    except ValueError:
        ov = 0.0
    if ov > 0:
        flops, source = ov, "env"
    try:
        ovb = float(env.get("BYTEPS_PEAK_BW_GBPS", "0") or "0")
    except ValueError:
        ovb = 0.0
    if ovb > 0:
        bw = ovb
    return float(flops), float(bw), source


def device_kind(device=None) -> str:
    """The device's name as the peak table reads it: the card's
    ``torch.cuda.get_device_name`` (e.g. "NVIDIA H100 80GB HBM3"), or
    "cpu"."""
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(dev)
        return "cpu" if dev is None else ""
    return dev.type


def count_flops(fn, *args, **kwargs) -> tuple:
    """``(fn's result, its FLOPs, counted)``: ``fn`` runs once under
    ``utils/flops.py``'s count, which adds FlopCounterMode's formulas
    over the ops PyTorch dispatches, forward and backward, and what the
    port's own kernels report for the work it cannot see. The FLOPs are
    None when a formula fails or the count finds none; ``counted`` is
    False when another thread's count was running (count again later)."""
    from ..utils import flops as flops_mod
    out, total, counted = flops_mod.count(fn, *args, **kwargs)
    if counted and total is None:
        log.warning("a FLOP formula failed: the ledger's cost model has no "
                    "FLOPs, and MFU reads None")
    return out, total if total else None, counted


def overlap_fraction(wire_spans: Sequence[Tuple[float, float]],
                     compute_end_s: float) -> Optional[float]:
    """Fraction of wire time hidden under compute.

    ``wire_spans`` are this step's wire exchanges as (start, end)
    seconds relative to step start (the scheduler's submit→completion
    PULL intervals — wire + server aggregation wait); the compute
    interval is [0, compute_end_s] (backward dispatch through the last
    leaf leaving the device). Spans are union-merged first so striped
    concurrent exchanges never double-count, then intersected with the
    compute interval: 1.0 = every wire second ran under the backward
    (perfect overlap), 0.0 = the wire only ran after compute finished
    (the synchronous shape). None when no wire span was recorded."""
    ivs = sorted((max(0.0, float(s)), float(e))
                 for s, e in wire_spans if e > s)
    if not ivs:
        return None
    merged: List[List[float]] = []
    for s, e in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = sum(e - s for s, e in merged)
    if total <= 0:
        return None
    hidden = sum(max(0.0, min(e, compute_end_s) - s)
                 for s, e in merged if s < compute_end_s)
    return min(1.0, hidden / total)


def roofline_fraction(flops: Optional[float],
                      bytes_accessed: Optional[float],
                      peak_flops: float,
                      peak_bw_gbps: float) -> Optional[float]:
    """The cost model's attainable-MFU bound: arithmetic intensity
    (FLOPs per byte accessed) times memory bandwidth, capped at the
    compute peak, as a fraction of that peak — the "of 0.58 roofline"
    part of the efficiency verdict. None without both cost terms."""
    if not (flops and bytes_accessed and peak_flops and peak_bw_gbps):
        return None
    attainable = min(peak_flops,
                     (flops / bytes_accessed) * peak_bw_gbps * 1e9)
    return attainable / peak_flops


def register_ledger_metrics(metrics) -> None:
    """Eagerly create the ledger's instrument family so the documented
    schema resolves on every deployment (the codec/autoscale pattern):
    the drop counter plus last-step efficiency gauges — the Prometheus
    face of the ledger (``byteps_ledger_*`` series)."""
    metrics.counter("ledger/efficiency_drops")
    metrics.gauge("ledger/mfu")
    metrics.gauge("ledger/overlap_frac")
    metrics.gauge("ledger/wire_efficiency")
    metrics.gauge("ledger/achieved_tflops")


class PerfArchive:
    """Step-indexed JSONL perf recorder (``BYTEPS_PERF_ARCHIVE``).

    ``append`` buffers one pre-serialized line (no file I/O on the
    step path); the buffer writes out every ``flush_steps`` records,
    at ``flush()`` (shutdown / SIGTERM hook) and is bounded — a dead
    filesystem degrades to counted drops, never an unbounded list."""

    def __init__(self, directory: str, flush_steps: int = 32,
                 max_buffer: int = 4096):
        self.dir = directory
        self.path = os.path.join(directory, f"perf-{os.getpid()}.jsonl")
        self._flush_steps = max(1, int(flush_steps))
        self._max_buffer = max(self._flush_steps, int(max_buffer))
        self._mu = threading.Lock()
        self._buf: List[str] = []   # guarded-by: _mu
        self.records = 0            # guarded-by: _mu
        self.dropped = 0            # guarded-by: _mu
        os.makedirs(directory, exist_ok=True)

    def append(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._mu:
            if len(self._buf) >= self._max_buffer:
                self._buf.pop(0)
                self.dropped += 1
            self._buf.append(line)
            self.records += 1
            need_flush = len(self._buf) >= self._flush_steps
        if need_flush:
            self.flush()

    def flush(self, lock_timeout: Optional[float] = None) -> None:
        """``lock_timeout`` is for the SIGTERM path: the signal handler
        runs on whatever thread held ``_mu`` mid-append, and a blocking
        acquire there would deadlock the whole dump — better to lose
        the buffered tail than hang the process (the flight dump that
        follows must still run)."""
        if lock_timeout is None:
            self._mu.acquire()
        elif not self._mu.acquire(timeout=lock_timeout):
            return
        try:
            # held via the bounded acquire above (the lexical rule only
            # sees `with` blocks)
            lines, self._buf = self._buf, []  # bps-lint: disable=guarded-by
        finally:
            self._mu.release()
        if not lines:
            return
        try:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            if self._mu.acquire(timeout=1.0):
                try:
                    # held via the bounded acquire on the line above
                    self.dropped += len(lines)  # bps-lint: disable=guarded-by
                finally:
                    self._mu.release()

    def stats(self) -> dict:
        with self._mu:
            return {"records": self.records, "dropped": self.dropped}


class EfficiencyLedger:
    """The per-lifecycle efficiency state: registered cost model,
    resolved device peak, trailing efficiency window, perf archive.

    ``register_step_cost`` is called by the train step once per plan; ``step_efficiency`` is called by ``StepProfiler.end_step``
    on the train thread; ``on_step`` rides the profiler's observer
    hook (also train thread) for archive + drop detection. All state
    mutations take one lock; the per-step work is a handful of float
    ops plus (archive on) one dict + dumps."""

    def __init__(self, config=None, metrics=None, device=None):
        self.enabled = bool(getattr(config, "ledger", True))
        # the device whose name picks the peak row (None: card 0 if
        # there is one, else the CPU)
        self._device = device
        self._mu = threading.Lock()
        self._cost: Optional[dict] = None         # guarded-by: _mu
        self._peak: Optional[tuple] = None        # guarded-by: _mu
        self._cfg_peak = float(getattr(config, "peak_flops", 0.0) or 0.0)
        self._cfg_bw = float(getattr(config, "peak_bw_gbps", 0.0) or 0.0)
        self._drop_frac = float(
            getattr(config, "eff_drop_frac", 0.25) or 0.25)
        window = int(getattr(config, "eff_drop_window", 16) or 16)
        self._windows: Dict[str, collections.deque] = {  # guarded-by: _mu
            "mfu": collections.deque(maxlen=max(4, window)),
            "overlap_frac": collections.deque(maxlen=max(4, window)),
        }
        self._device_kind: Optional[str] = None   # guarded-by: _mu
        self.archive: Optional[PerfArchive] = None
        arch_dir = getattr(config, "perf_archive", "") or ""
        if self.enabled and arch_dir:
            try:
                self.archive = PerfArchive(
                    arch_dir,
                    flush_steps=getattr(config, "perf_flush_steps", 32))
            except OSError:
                self.archive = None
        self._m_push = self._m_pull = None
        self._m_drops = None
        self._gauges: Dict[str, object] = {}
        if metrics is not None:
            self._m_push = metrics.counter("wire/push_bytes")
            self._m_pull = metrics.counter("wire/pull_bytes")
            self._m_drops = metrics.counter("ledger/efficiency_drops")
            for g in ("mfu", "overlap_frac", "wire_efficiency",
                      "achieved_tflops"):
                self._gauges[g] = metrics.gauge(f"ledger/{g}")

    @property
    def archive_enabled(self) -> bool:
        return self.archive is not None

    # -- cost-model registration (the train step) ---------------------- #

    def register_step_cost(self, flops: Optional[float] = None,
                           bytes_accessed: Optional[float] = None,
                           ideal_wire_bytes: Optional[int] = None,
                           source: str = "none") -> None:
        """One train-step plan's cost model: the FLOPs (and bytes, where
        known) of its forward and backward plus the plan's ideal
        exchange bytes. Re-registered when the plan changes (tree
        reshape, knob flip); an absent count leaves ``flops`` None — MFU
        then reads None, never silently 0."""
        with self._mu:
            self._cost = {
                "flops": float(flops) if flops else None,
                "bytes_accessed": (float(bytes_accessed)
                                   if bytes_accessed else None),
                "ideal_wire_bytes": (int(ideal_wire_bytes)
                                     if ideal_wire_bytes else None),
                "source": source,
            }

    def cost(self) -> Optional[dict]:
        with self._mu:
            return dict(self._cost) if self._cost else None

    # -- peak resolution (lazy: first use queries the backend) --------- #

    def _resolve_peak(self) -> tuple:
        with self._mu:
            if self._peak is not None:
                return self._peak
        try:
            kind = device_kind(self._device)
        except Exception:  # noqa: BLE001 - no backend: defaults apply
            kind = ""
        flops, bw, source = detect_peak(kind)
        if self._cfg_peak > 0:
            flops, source = self._cfg_peak, "config"
        if self._cfg_bw > 0:
            bw = self._cfg_bw
        with self._mu:
            peak = self._peak = (flops, bw, source)
            self._device_kind = kind or None
        return peak

    def peak_flops(self) -> float:
        return self._resolve_peak()[0]

    # -- per-step pricing (StepProfiler.end_step, train thread) -------- #

    def wire_bytes_total(self) -> Optional[int]:
        if self._m_push is None:
            return None
        return int(self._m_push.value) + int(self._m_pull.value)

    def step_efficiency(self, wall_s: float, compute_end_s: float,
                        wire_spans: Sequence[tuple],
                        wire_base: Optional[int]) -> dict:
        """Price one finished step: the new StepReport fields, computed
        from the registered cost model, the step's wire-span timeline
        and the wire byte counters' step delta. Every field degrades
        independently to None — a missing cost model still yields
        overlap/wire figures and vice versa."""
        if not self.enabled:
            return {}
        out: dict = {}
        cost = self.cost()
        peak_f, peak_bw, _ = self._resolve_peak()
        if cost and cost["flops"] and wall_s > 0:
            achieved = cost["flops"] / wall_s
            out["achieved_flops"] = achieved
            if peak_f > 0:
                out["mfu"] = achieved / peak_f
            rf = roofline_fraction(cost["flops"], cost["bytes_accessed"],
                                   peak_f, peak_bw)
            if rf is not None:
                out["roofline_frac"] = rf
        of = overlap_fraction(wire_spans, compute_end_s)
        if of is not None:
            out["overlap_frac"] = of
        if wire_base is not None:
            total = self.wire_bytes_total()
            if total is not None:
                delta = max(0, total - wire_base)
                out["wire_bytes"] = delta
                if cost and cost["ideal_wire_bytes"] and delta > 0:
                    out["wire_efficiency"] = \
                        cost["ideal_wire_bytes"] / delta
        return out

    # -- step observer: archive + drop detection (train thread) -------- #

    def on_step(self, report) -> None:
        if not self.enabled:
            return
        mfu = getattr(report, "mfu", None)
        overlap = getattr(report, "overlap_frac", None)
        wire_eff = getattr(report, "wire_efficiency", None)
        if self._gauges:
            if mfu is not None:
                self._gauges["mfu"].set(mfu)
            if overlap is not None:
                self._gauges["overlap_frac"].set(overlap)
            if wire_eff is not None:
                self._gauges["wire_efficiency"].set(wire_eff)
            af = getattr(report, "achieved_flops", None)
            if af is not None:
                self._gauges["achieved_tflops"].set(af / 1e12)
        self._check_drop(report, mfu=mfu, overlap_frac=overlap)
        if self.archive is not None:
            self.archive.append(self._archive_record(report))

    def _check_drop(self, report, **values) -> None:
        """``efficiency_drop`` flight event when a metric falls more
        than the configured fraction below its trailing-window median
        (≥ 4 prior samples, so warmup can't fire it). The window then
        still absorbs the new value — a sustained lower plateau fires
        once per drop edge plus while the median catches up, not
        forever."""
        from . import flight
        step = int(getattr(report, "step", 0))
        with self._mu:
            for key, v in values.items():
                if v is None:
                    continue
                win = self._windows[key]
                if len(win) >= 4:
                    s = sorted(win)
                    med = s[len(s) // 2]
                    if med > 0 and v < med * (1.0 - self._drop_frac):
                        flight.record(
                            "efficiency_drop", key=step,
                            detail=f"{key} {v:.4f} fell "
                                   f">{self._drop_frac:.0%} below "
                                   f"trailing median {med:.4f} "
                                   f"(window {len(win)})")
                        if self._m_drops is not None:
                            self._m_drops.inc()
                win.append(v)

    @staticmethod
    def _archive_record(report) -> dict:
        rec = {"ts_ns": time.monotonic_ns()}
        for k in ("step", "wall_ms", "compute_ms", "drain_ms",
                  "ttfp_ms", "pull_p95_ms", "achieved_flops", "mfu",
                  "overlap_frac", "wire_efficiency", "wire_bytes",
                  "queue_depth_peak", "credit_stalls",
                  # training-health fields (core/health.py): archived
                  # so a perf record also tells you whether the run
                  # was numerically sane
                  "grad_norm", "update_ratio_p95", "nonfinite_leaves",
                  "fidelity_drift"):
            v = getattr(report, k, None)
            if isinstance(v, float):
                v = round(v, 6)
            rec[k] = v
        return rec

    # -- exposition ---------------------------------------------------- #

    def snapshot(self) -> dict:
        """The ``ledger`` section of ``get_metrics()`` (fixed keys);
        flattens to ``byteps_ledger_*`` Prometheus gauges alongside the
        instrument family."""
        peak = None
        with self._mu:
            cost = dict(self._cost) if self._cost else {}
            peak = self._peak
            kind = self._device_kind
        if peak is None and self.enabled:
            peak = self._resolve_peak()
            with self._mu:
                kind = self._device_kind
        arch = self.archive.stats() if self.archive else \
            {"records": 0, "dropped": 0}
        return {
            "enabled": self.enabled,
            "source": cost.get("source", "none"),
            "model_flops": cost.get("flops"),
            "model_bytes": cost.get("bytes_accessed"),
            "ideal_wire_bytes": cost.get("ideal_wire_bytes"),
            "peak_flops": peak[0] if peak else None,
            "peak_bw_gbps": peak[1] if peak else None,
            "peak_source": peak[2] if peak else None,
            "roofline_frac": roofline_fraction(
                cost.get("flops"), cost.get("bytes_accessed"),
                peak[0], peak[1]) if peak else None,
            "device_kind": kind,
            "archive_path": self.archive.path if self.archive else None,
            "archive_records": arch["records"],
            "archive_dropped": arch["dropped"],
        }

    def flush(self) -> None:
        if self.archive is not None:
            self.archive.flush()

    def term_flush(self) -> None:
        """The SIGTERM hook: bounded lock acquire — the handler may be
        running on the very thread the signal interrupted mid-append,
        and blocking there would deadlock the flight dump too."""
        if self.archive is not None:
            self.archive.flush(lock_timeout=1.0)

    def close(self) -> None:
        self.flush()
