"""The training-health plane: numerics anomalies made loud.

Port of byteps_tpu/core/health.py, the worker half of the plane (the
native half is ``ps.cc``'s in-fold statistics pass under BYTEPS_HEALTH:
each published aggregate's sum of squares, abs-max and NaN/Inf count,
read per key over HEALTH_PULL or in process by ``server.key_health``):

- ``StepHealthCollector``: taps the host tier's completion-ordered drain
  on each pulled aggregate as it lands in its host slot, before its copy
  to the card; per leaf a sum of squares (f32 dots of 65,536 elements
  summed in f64, where the JAX tap takes one f32 dot a piece) and a
  nonfinite count, giving
  the StepReport's ``grad_norm``, ``update_ratio_p95`` and
  ``nonfinite_leaves``.
- ``HealthDetector``: a pure, clockless hysteresis detector (streaks and
  cooldowns, no wall clock, no RNG) over four anomaly classes:
  nonfinite gradients, explosion and collapse of the gradient norm
  against its trailing median, and compression-fidelity drift. The same
  signal sequence gives the same verdicts.
- ``HealthPlane``: a StepProfiler observer that runs the detector each
  finished step, stamps its verdict on the report (``health_flags``),
  mirrors it into the ``health/*`` instruments and flight events,
  compares the server's in-fold norm with the worker's for the leaves
  on a lossy codec (the drift signal), and under BYTEPS_NAN_GUARD
  latches an error that the train step raises (``raise_if_fatal``)
  after the flight record is dumped.

The port has no adaptive codec plane yet: the lossy leaves are those the
step names (``finalize``'s ``tiers``, each compressed leaf's codec).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

__all__ = [
    "HealthSignal", "HealthDetector", "HealthPlane",
    "StepHealthCollector", "register_health_metrics", "ANOMALY_CLASSES",
]

# elements of one f32 dot in the collector's sum of squares
_DOT_CHUNK = 1 << 16

# the lossy wire codecs (byteps_tpu/core/codec_plane.py:75): the fidelity
# check compares the server's norm with the worker's on these alone
_LOSSY_TIERS = frozenset(("onebit", "topk", "randomk", "dithering"))

# the four anomaly classes, in report order
ANOMALY_CLASSES = ("nonfinite", "explode", "collapse", "drift")


def register_health_metrics(metrics) -> None:
    """Create the health plane's instruments eagerly so the
    snapshot has them on every deployment,
    health pass enabled or not (the codec/wire-retries contract)."""
    metrics.counter("health/nonfinite_rounds")
    metrics.counter("health/explode_events")
    metrics.counter("health/collapse_events")
    metrics.counter("health/drift_events")
    metrics.gauge("health/grad_norm")
    metrics.gauge("health/update_ratio_p95")


@dataclasses.dataclass
class HealthSignal:
    """One step boundary's deterministic numerics inputs — every field
    is a post-aggregation statistic, identical on every worker."""

    step: int
    grad_norm: Optional[float] = None
    nonfinite_leaves: int = 0
    fidelity_drift: Optional[float] = None


class HealthDetector:
    """Pure clockless hysteresis detector over the four anomaly
    classes. ``observe(sig)`` advances the streak/cooldown state with
    one step's signal and returns the tuple of anomaly names that
    FIRED this step (empty = healthy). Deterministic: a pure function
    of (state, signal) — two detectors fed identical signal sequences
    emit identical verdict sequences (test-pinned)."""

    def __init__(self, window: int = 16, explode_ratio: float = 10.0,
                 collapse_ratio: float = 0.01, streak: int = 2,
                 drift_frac: float = 0.1, cooldown: int = 8):
        import collections
        self.window = max(4, int(window))
        self.explode_ratio = float(explode_ratio)
        self.collapse_ratio = float(collapse_ratio)
        self.streak = max(1, int(streak))
        self.drift_frac = float(drift_frac)
        self.cooldown = max(0, int(cooldown))
        # trailing window of HEALTHY grad norms: the comparison
        # baseline. Nonfinite rounds never enter it (a NaN would erase
        # the median), and the window absorbs each finite value AFTER
        # the comparison, so a sustained explosion fires on the edge
        # and again after the cooldown while the median catches up —
        # the ledger's efficiency_drop discipline.
        self._norms = collections.deque(maxlen=self.window)
        self._streaks = {"explode": 0, "collapse": 0, "drift": 0}
        self._cooldowns = {"explode": 0, "collapse": 0, "drift": 0}

    def _median(self) -> Optional[float]:
        if len(self._norms) < 4:  # warmup: no baseline yet
            return None
        s = sorted(self._norms)
        return s[len(s) // 2]

    def _clock(self, name: str, condition: bool) -> bool:
        """One class's hysteresis step: ``streak`` consecutive
        condition-true rounds fire the event, a fire opens a
        ``cooldown`` window during which the class stays silent (no
        flapping), any condition-false round resets the streak."""
        if not condition:
            self._streaks[name] = 0
            return False
        self._streaks[name] += 1
        if self._streaks[name] < self.streak or self._cooldowns[name]:
            return False
        self._streaks[name] = 0
        self._cooldowns[name] = self.cooldown
        return True

    def observe(self, sig: HealthSignal) -> Tuple[str, ...]:
        for name in self._cooldowns:
            if self._cooldowns[name]:
                self._cooldowns[name] -= 1
        flags: List[str] = []
        # class 1 — nonfinite gradients: no hysteresis, every poisoned
        # round is an event (the guard rides this class)
        if sig.nonfinite_leaves:
            flags.append("nonfinite")
        med = self._median()
        gn = sig.grad_norm
        finite_norm = (gn is not None and gn == gn
                       and gn != float("inf"))
        # a poisoned round's norm covers only its finite elements —
        # partial by definition, so the magnitude classes sit it out
        # (the nonfinite class already named the round anomalous)
        if finite_norm and not sig.nonfinite_leaves \
                and med is not None and med > 0:
            # class 2 — gradient explosion vs the trailing median
            if self._clock("explode", gn > self.explode_ratio * med):
                flags.append("explode")
            # class 3 — norm-collapse stall
            if self._clock("collapse", gn < self.collapse_ratio * med):
                flags.append("collapse")
        # class 4 — compression-fidelity drift (server in-fold norm vs
        # the worker-recomputed norm, per codec tier)
        if self._clock("drift", sig.fidelity_drift is not None
                       and sig.fidelity_drift > self.drift_frac):
            flags.append("drift")
        if finite_norm and not sig.nonfinite_leaves:
            self._norms.append(gn)
        return tuple(flags)


class StepHealthCollector:
    """One train step's per-leaf gradient statistics, fed by the
    completion-ordered drain as each pulled aggregate lands (whole
    leaves, fused-bucket slices and per-device shards alike — shard
    pieces accumulate into their leaf's slot, and zero-padded tails
    contribute exactly 0). The cost is one BLAS dot per piece over
    bytes the H2D import is touching anyway; the precise
    ``np.isfinite`` pass runs only when the fast dot came back
    nonfinite (a poisoned or overflowing leaf — rare by definition)."""

    __slots__ = ("n", "_mu", "sumsq", "nonfinite", "param_norms_dev")

    def __init__(self, n: int):
        self.n = n
        self._mu = threading.Lock()
        self.sumsq = [0.0] * n      # guarded-by: _mu
        self.nonfinite = [0] * n    # guarded-by: _mu
        # device array of per-leaf param norms (train thread sets it at
        # dispatch, finalize materializes it — the D2H is len(names)
        # floats, not the model)
        self.param_norms_dev = None

    def leaf(self, i: int, piece) -> None:
        """Accumulate one drained piece's statistics (drain thread;
        must never raise into the import loop)."""
        import numpy as np
        try:
            x = np.asarray(piece).ravel()
            if x.dtype.kind != "f" or x.dtype.itemsize < 4:
                x = x.astype(np.float32)
            # one f32 dot a chunk, the chunks summed in f64: a single dot
            # over a 25M-element leaf (the JAX tap's) drifts 1e-5
            # relative from the exact sum of squares
            ss = sum(float(np.dot(c, c)) for c in
                     (x[j:j + _DOT_CHUNK]
                      for j in range(0, x.size, _DOT_CHUNK)))
            nf = 0
            if not np.isfinite(ss):
                # nonfinite elements OR f32 overflow: take the precise
                # pass — count the poisoned lanes, sum the finite ones
                # in double so the norm stays meaningful
                fin = np.isfinite(x)
                nf = int(x.size - int(fin.sum()))
                xf = np.where(fin, x, 0).astype(np.float64)
                ss = float(np.dot(xf, xf))
        except Exception:  # noqa: BLE001 - diagnostics must not kill
            return                   # the drain
        with self._mu:
            self.sumsq[i] += ss
            if nf:
                self.nonfinite[i] += nf


class HealthPlane:
    """Worker-side glue (see module docstring). Constructed per init
    lifecycle by ``core/state.py``; ``enabled`` mirrors
    ``BYTEPS_HEALTH``."""

    def __init__(self, config, metrics):
        self.enabled = bool(getattr(config, "health", False))
        if self.enabled and not getattr(metrics, "enabled", True):
            # the detector/guard ride the StepProfiler's observer hook,
            # which BYTEPS_METRICS=0 freezes — collecting would pay the
            # full per-step cost with the verdict (and the NaN guard)
            # never computed. Refuse loudly instead of silently
            # degrading to overhead-without-protection.
            from ..utils.logging import log
            log.warning(
                "BYTEPS_HEALTH=1 requires BYTEPS_METRICS=1 (the "
                "health detector rides the step profiler) — disabling "
                "the training-health plane for this lifecycle")
            self.enabled = False
        self.nan_guard = bool(getattr(config, "nan_guard", False))
        self.num_workers = max(1, int(getattr(config, "num_workers", 1)))
        self.drift_keys = max(0, int(getattr(config, "health_drift_keys",
                                             8)))
        self.detector = HealthDetector(
            window=getattr(config, "health_window", 16),
            explode_ratio=getattr(config, "health_explode_ratio", 10.0),
            collapse_ratio=getattr(config, "health_collapse_ratio",
                                   0.01),
            streak=getattr(config, "health_streak", 2),
            drift_frac=getattr(config, "health_drift_frac", 0.1))
        self._mu = threading.Lock()
        self._fatal: Optional[BaseException] = None  # guarded-by: _mu
        self._m_nonfinite = metrics.counter("health/nonfinite_rounds")
        self._m_explode = metrics.counter("health/explode_events")
        self._m_collapse = metrics.counter("health/collapse_events")
        self._m_drift = metrics.counter("health/drift_events")
        self._g_norm = metrics.gauge("health/grad_norm")
        self._g_ratio = metrics.gauge("health/update_ratio_p95")

    # -- per-step collection (training/train.py drain tap) ------------- #

    def begin_collect(self, n_leaves: int) -> Optional[StepHealthCollector]:
        if not self.enabled:
            return None
        return StepHealthCollector(n_leaves)

    def finalize(self, col: StepHealthCollector, names: List[str],
                 state, tiers: Optional[dict] = None) -> dict:
        """Close one step's collection into the StepReport's health
        fields (train thread, after the drain). Every field degrades
        independently to None — never a silent 0."""
        import numpy as np
        total_ss = 0.0
        nonfinite_leaves = 0
        with col._mu:
            sumsq = list(col.sumsq)
            nonfin = list(col.nonfinite)
        for i in range(col.n):
            total_ss += sumsq[i]
            if nonfin[i]:
                nonfinite_leaves += 1
        grad_norm = float(total_ss ** 0.5)
        # per-leaf update-to-param ratios from the param norms taken at
        # the step's start (the ||g||/||p|| trust-ratio proxy — the
        # update IS lr-scaled gradient for the separable transforms the
        # sharded apply covers, so the ratio tracks update magnitude up
        # to the learning rate, deterministically across workers)
        ratio_p95 = None
        pn = None
        if col.param_norms_dev is not None:
            try:
                pn = col.param_norms_dev
                if hasattr(pn, "cpu"):     # a tensor on the card
                    pn = pn.detach().cpu().numpy()
                pn = np.asarray(pn)
            except Exception:  # noqa: BLE001 - ratios degrade to None
                pn = None
        if pn is not None and pn.size >= col.n:
            ratios = sorted(
                (sumsq[i] ** 0.5) / (float(pn[i]) + 1e-12)
                for i in range(col.n))
            if ratios:
                ratio_p95 = float(
                    ratios[min(len(ratios) - 1,
                               int(0.95 * len(ratios)))])
        drift = self._fidelity_drift(sumsq, nonfin, names, state, tiers)
        return {
            "grad_norm": grad_norm,
            "update_ratio_p95": ratio_p95,
            "nonfinite_leaves": nonfinite_leaves,
            "fidelity_drift": drift,
        }

    def _fidelity_drift(self, sumsq, nonfin, names, state, tiers=None):
        """Server in-fold aggregate norm vs the worker-recomputed norm,
        for the leaves on a lossy codec (bounded at ``drift_keys``
        leaves per step): ``tiers`` maps a leaf's name to its codec. The
        worker norm is of the post-average pulled value, so it is
        rescaled by num_workers before comparing with the server's
        sum-side statistic. None when no lossy leaf / no fleet — never a
        fabricated 0."""
        client = getattr(state, "ps_client", None)
        registry = getattr(state, "registry", None)
        if (not tiers or client is None or registry is None
                or not self.drift_keys
                or not hasattr(client, "health_pull")):
            return None
        worst = None
        attempted = 0
        for i, name in enumerate(names):
            tier = tiers.get(name, "dense")
            # LOSSY tiers only: lossless is a bitwise round-trip whose
            # drift is ~0 by construction — letting it consume the
            # bounded drift_keys budget would starve the onebit leaves
            # the signal exists for
            if tier not in _LOSSY_TIERS or nonfin[i] or sumsq[i] <= 0:
                continue
            ctx = registry.get(name)
            if ctx is None or not ctx.partitions:
                continue
            # bound ATTEMPTS, not successes: a wedged (gray-failed)
            # server must cost at most drift_keys bounded pulls per
            # step, never a sweep of every lossy leaf
            attempted += 1
            srv_ss = 0.0
            ok = True
            for p in ctx.partitions:
                try:
                    rec = client.health_pull(p.server, p.key,
                                             timeout_s=1)
                except Exception:  # noqa: BLE001 - dead server: skip
                    rec = None
                if rec is None or not rec.get("elems"):
                    ok = False
                    break
                srv_ss += rec["sumsq"]
            if ok:
                worker_norm = (sumsq[i] ** 0.5) * self.num_workers
                drift = abs(srv_ss ** 0.5 - worker_norm) / max(
                    worker_norm, 1e-12)
                if worst is None or drift > worst:
                    worst = drift
            if attempted >= self.drift_keys:
                break
        return worst

    # -- step observer (train thread, core/metrics.py) ----------------- #

    def on_step(self, report) -> None:
        """Run the detector over one finished StepReport; stamp the
        verdict (``health_flags``) onto the report — the codec plane's
        veto input and ``classify_step``'s health segment — and mirror
        it into instruments + flight events. With BYTEPS_NAN_GUARD, a
        nonfinite round dumps the flight record and latches the
        fail-fast error the train step raises (``raise_if_fatal``)."""
        if not self.enabled:
            return
        gn = getattr(report, "grad_norm", None)
        nf = int(getattr(report, "nonfinite_leaves", None) or 0)
        drift = getattr(report, "fidelity_drift", None)
        if gn is None and not nf:
            return  # no health collection ran this step
        flags = self.detector.observe(HealthSignal(
            step=report.step, grad_norm=gn, nonfinite_leaves=nf,
            fidelity_drift=drift))
        report.health_flags = flags
        if gn is not None:
            self._g_norm.set(gn)
        if getattr(report, "update_ratio_p95", None) is not None:
            self._g_ratio.set(report.update_ratio_p95)
        from . import flight
        if "nonfinite" in flags:
            self._m_nonfinite.inc()
            flight.record(
                "health_nonfinite", key=report.step,
                detail=f"{nf} gradient leaves carried NaN/Inf at step "
                       f"{report.step}")
        if "explode" in flags:
            self._m_explode.inc()
            flight.record(
                "health_explode", key=report.step,
                detail=f"grad_norm {gn:.4g} exceeded "
                       f"{self.detector.explode_ratio:g}x the trailing "
                       f"median at step {report.step}")
        if "collapse" in flags:
            self._m_collapse.inc()
            flight.record(
                "health_collapse", key=report.step,
                detail=f"grad_norm {gn:.4g} fell below "
                       f"{self.detector.collapse_ratio:g}x the trailing "
                       f"median at step {report.step} (stall)")
        if "drift" in flags:
            self._m_drift.inc()
            flight.record(
                "health_drift", key=report.step,
                detail=f"compression-fidelity drift {drift:.4g} beyond "
                       f"{self.detector.drift_frac:g} at step "
                       f"{report.step}")
        if self.nan_guard and "nonfinite" in flags:
            self._latch_fatal(report.step, nf)

    def _latch_fatal(self, step: int, nf: int) -> None:
        """Dump the flight record (detect → flight → fail-fast, the
        ``_fatal_wire_error`` contract) and latch the error for the
        train thread. Latched once: a re-raise loop must not re-dump."""
        with self._mu:
            if self._fatal is not None:
                return
        from . import flight
        try:
            path = flight.dump(reason="nan-guard")
        except Exception:  # noqa: BLE001 - never mask the real error
            path = None
        msg = (f"BYTEPS_NAN_GUARD: {nf} gradient leaves carried "
               f"NaN/Inf at step {step}; failing fast before the "
               f"poisoned aggregate trains on")
        if path:
            msg += f" — flight record dumped to {path}"
        with self._mu:
            if self._fatal is None:
                self._fatal = RuntimeError(msg)

    def raise_if_fatal(self) -> None:
        """Raise (once) the guard's latched error on the train thread
        — called by the train step after end_step, so the flight
        events and counters land BEFORE the raise."""
        with self._mu:
            err = self._fatal
            self._fatal = None
        if err is not None:
            raise err
