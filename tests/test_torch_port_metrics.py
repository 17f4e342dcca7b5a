"""The port's metrics registry and step profiler against the JAX
package's (``core/metrics.py``; exact comparisons throughout):

- one sequence of instrument operations (counters, gauges with a
  callback and a ratchet, histograms across the log2 buckets, sections)
  gives equal snapshots and byte-identical Prometheus text;
- one table of StepReports, each built from one dict in both packages,
  gives the same ``classify_step`` and ``server_attribution`` strings;
- a ``StepProfiler`` fed one sequence of samples, marks, probes and
  ledger prices closes the same reports and runs its observers;
- BYTEPS_METRICS=0 makes every instrument op a no-op;
- the ``/metrics`` endpoint serves the registry's text, whose counters
  parse back to the snapshot's.
"""

import dataclasses
import urllib.request

import numpy as np
import pytest

from byteps_tpu.core import metrics as J
from byteps_tpu_torch.core import metrics as T


def _drive(mod, rs_seed=0, enabled=True):
    rs = np.random.RandomState(rs_seed)
    reg = mod.MetricsRegistry(enabled=enabled)
    for i in range(40):
        reg.counter(f"wire/c{i % 5}").inc(int(rs.randint(0, 1 << 20)))
    g = reg.gauge("scheduler/queue_depth")
    for v in rs.randint(0, 50, 10):
        g.set(int(v))
    peak = reg.gauge("wire/inflight_peak")
    for v in rs.randint(0, 50, 10):
        peak.set_max(int(v))
    reg.gauge("arena/live").set_fn(lambda: 7.5)
    h = reg.histogram("scheduler/pull_us/dense")
    # every bucket from 0 to past the last one, and a negative sample
    for v in [0, 1, 2, 3, 1023, 1024, -5, 2 ** 40] + \
            list(rs.exponential(5000.0, 200)):
        h.record(float(v))
    reg.histogram("step/h2d_update_us").record_seconds(0.0125)
    reg.histogram("empty_us")
    reg.section("arena", lambda: {"slots_live": 3, "enabled": True,
                                  "name": "skipped", "ttfp": 1.25})
    reg.section("fleet", lambda: {"workers": 1, "servers": 2,
                                  "source": "wire", "server": {
                                      "0": {"fold_ms": 1.5, "draining": 0},
                                      "1": {"fold_ms": 2.0,
                                            "draining": 1}}})
    reg.section("broken", lambda: 1 / 0)
    return reg


@pytest.mark.parametrize("enabled", [True, False], ids=["on", "off"])
def test_instruments_snapshot_and_prometheus_text_equal_jax(enabled):
    j, t = _drive(J, enabled=enabled), _drive(T, enabled=enabled)
    assert t.snapshot() == j.snapshot()
    assert T.prometheus_text(t) == J.prometheus_text(j)
    assert T.HIST_BUCKETS == J.HIST_BUCKETS
    if not enabled:
        snap = t.snapshot()
        assert set(snap["counters"].values()) == {0}
        assert snap["histograms"]["scheduler/pull_us/dense"]["count"] == 0


def test_histogram_percentiles_equal_jax():
    rs = np.random.RandomState(3)
    jh, th = J.Histogram("x"), T.Histogram("x")
    for v in rs.lognormal(8, 3, 1000):
        jh.record(v)
        th.record(v)
    for p in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert th.percentile(p) == jh.percentile(p)


# one dict a report: each stresses another branch of the verdict
REPORTS = [
    dict(step=1, wall_ms=50.0, compute_ms=40.0),
    dict(step=2, wall_ms=90.0, compute_ms=10.0, pull_p95_ms=41.0,
         push_p95_ms=3.0, queue_depth_peak=37, credit_stalls=2,
         ttfp_ms=1.5),
    dict(step=3, wall_ms=90.0, compute_ms=10.0, pull_p95_ms=5.0,
         pull_wait_ms=60.0, pull_total_ms=80.0, server_recv_ms=2.0,
         server_queue_ms=30.1, server_fold_ms=4.2, server_reply_ms=1.0),
    dict(step=4, wall_ms=90.0, compute_ms=10.0, pull_p95_ms=70.0,
         pull_total_ms=200.0, server_recv_ms=1.0, server_queue_ms=3.0,
         server_fold_ms=50.0, server_reply_ms=1.0, mfu=0.31,
         roofline_frac=0.58, overlap_frac=0.62, wire_efficiency=0.5),
    dict(step=5, wall_ms=30.0, compute_ms=5.0, compress_p95_ms=20.0,
         grad_norm=0.031, update_ratio_p95=2.1e-4, nonfinite_leaves=0),
    dict(step=6, wall_ms=30.0, compute_ms=5.0, h2d_update_p95_ms=9.0,
         grad_norm=12.0, nonfinite_leaves=3, fidelity_drift=0.25,
         health_flags=("nonfinite", "drift")),
    dict(step=7, wall_ms=30.0, compute_ms=25.0, lane_count=4,
         lane_share_max=0.51, lane_share_min=0.04, lane_share_median=0.23,
         lane_max_id=1, lane_min_id=3, lane_server=0, mfu=0.1,
         overlap_frac=0.0),
    dict(step=8, wall_ms=30.0, compute_ms=25.0, pull_total_ms=5.0,
         server_queue_ms=None, carried_leaves=2, carry_drain_ms=1.0,
         staleness_lag=1, window_depth=3),
]


@pytest.mark.parametrize("fields", REPORTS, ids=lambda f: f"step{f['step']}")
def test_classify_step_and_server_attribution_equal_jax(fields):
    jr, tr = J.StepReport(**fields), T.StepReport(**fields)
    assert T.classify_step(tr) == J.classify_step(jr)
    assert T.server_attribution(tr) == J.server_attribution(jr)
    assert tr.as_dict() == jr.as_dict()


def test_step_report_fields_are_jax_fields():
    assert [f.name for f in dataclasses.fields(T.StepReport)] == \
        [f.name for f in dataclasses.fields(J.StepReport)]


class _Ledger:
    """A ledger stub: the same prices in both packages."""

    enabled = True

    def __init__(self):
        self.total = 0

    def wire_bytes_total(self):
        self.total += 1000
        return self.total

    def step_efficiency(self, wall_s, compute_end_s, wire_spans, wire_base):
        return {"mfu": 0.25, "achieved_flops": 1e12,
                "overlap_frac": float(len(wire_spans)),
                "wire_bytes": self.total - wire_base}


def _profile(mod):
    probes = iter([{"recv_ns": 10 ** 6 * i, "queue_ns": 3 * 10 ** 6 * i,
                    "fold_ns": 2 * 10 ** 6 * i, "reply_ns": 10 ** 6 * i}
                   for i in range(10)])
    seen = []
    prof = mod.StepProfiler(window=2, fleet_probe=lambda: next(probes),
                            ledger=_Ledger())
    prof.add_observer(lambda r: seen.append(r.step))
    prof.add_observer(lambda r: 1 / 0)       # must not kill the step
    out = []
    for s in range(3):
        b = prof.begin_step()
        for k in range(5):
            b.stage_sample("PULL", 0.001 * (k + s + 1))
            b.stage_sample("PUSH", 0.0005 * k)
            b.wire_span(b.t0 + 0.001 * k, b.t0 + 0.002 * k)
        b.queue_depth(4 + s)
        b.credit_stall()
        b.add_pull_wait(0.003)
        r = prof.end_step(b, ttfp_ms=1.0, streamed=3, fallback=1,
                          health={"grad_norm": 2.0, "nonfinite_leaves": 0})
        d = r.as_dict()
        # the walls are this run's clock; everything else is the input's
        for k in ("wall_ms", "compute_ms", "drain_ms", "tail_ms"):
            d.pop(k)
        out.append(d)
    return out, seen, len(prof.reports()), prof.snapshot()["count"]


def test_step_profiler_closes_the_same_reports_as_jax():
    assert _profile(T) == _profile(J)
    assert T.StepProfiler(enabled=False).begin_step() is None


def test_metrics_endpoint_serves_the_registry(monkeypatch):
    reg = _drive(T)
    server = T.start_http_server(lambda: reg, 0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert text == T.prometheus_text(reg)
    parsed = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            parsed[name] = float(value)
    for name, v in reg.snapshot()["counters"].items():
        assert parsed[T._prom_name(name)] == v
