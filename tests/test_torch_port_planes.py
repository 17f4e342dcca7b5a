"""The port's time-series, health, ledger and flight planes against the
JAX package's (exact comparisons unless a line says otherwise):

- a seeded sequence of StepReports gives identical series, snapshots and
  a byte-identical ``dump_jsonl``; every ``_TS_STEP_FIELDS`` name is a
  StepReport field;
- a seeded signal sequence that covers nonfinite, explode, collapse and
  drift gives identical ``HealthDetector`` verdicts, and the health
  plane's collector, finalize and guard agree;
- the pure ledger functions agree: ``detect_peak`` on the rows both
  tables share and on the CPU row (the port's H100 rows are its own),
  ``overlap_fraction``, ``roofline_fraction``, and an ``EfficiencyLedger``
  prices one step alike;
- the flight record merges the server events on the worker's clock as
  the JAX one does, and the SIGTERM hooks run in their pinned order.
"""

import json
import types

import numpy as np
import pytest

from byteps_tpu.core import flight as Jf
from byteps_tpu.core import health as Jh
from byteps_tpu.core import ledger as Jl
from byteps_tpu.core import metrics as Jm
from byteps_tpu.core import timeseries as Jt
from byteps_tpu.utils.tracing import estimate_clock_offset as j_offset
from byteps_tpu_torch.core import flight as Tf
from byteps_tpu_torch.core import health as Th
from byteps_tpu_torch.core import ledger as Tl
from byteps_tpu_torch.core import metrics as Tm
from byteps_tpu_torch.core import timeseries as Tt


def _reports(mod, seed=0, n=40):
    rs = np.random.RandomState(seed)
    out = []
    for s in range(1, n + 1):
        f = dict(step=s, wall_ms=float(rs.uniform(10, 50)),
                 compute_ms=float(rs.uniform(1, 10)),
                 queue_depth_peak=int(rs.randint(0, 9)),
                 mfu=float(rs.rand()) if s % 3 else None,
                 grad_norm=float(rs.lognormal()),
                 wire_bytes=int(rs.randint(1, 1 << 30)),
                 lane_bytes=((0, 1, int(rs.randint(0, 99))),
                             (1, 2, int(rs.randint(0, 99)))))
        out.append(mod.StepReport(**f))
    return out


def _series_run(mpkg, tpkg, tmp_path, name):
    reg = mpkg.MetricsRegistry()
    plane = tpkg.TimeSeriesPlane(points=16, registry=reg,
                                 dump_dir=str(tmp_path))
    c = reg.counter("wire/push_bytes")
    g = reg.gauge("scheduler/queue_depth")
    for i, r in enumerate(_reports(mpkg)):
        c.inc(1000 * i)
        g.set(i % 7)
        plane.observe(r)
    path = plane.dump_jsonl(path=str(tmp_path / name), reason="test")
    snap = plane.snapshot(tail=5)
    return plane.series(), plane.series(prefix="step/", tail=3), snap, \
        open(path, "rb").read()


def test_timeseries_equal_jax_and_dump_byte_for_byte(tmp_path):
    j = _series_run(Jm, Jt, tmp_path, "j.jsonl")
    t = _series_run(Tm, Tt, tmp_path, "t.jsonl")
    assert t[:3] == j[:3]
    assert t[3] == j[3]
    assert len(t[0]["step/wall_ms"]["steps"]) == 16      # the ring's depth
    assert Tt._TS_STEP_FIELDS == Jt._TS_STEP_FIELDS
    fields = {f for f in Tm.StepReport.__dataclass_fields__}
    assert set(Tt._TS_STEP_FIELDS) <= fields


def test_timeseries_breaker_trips_after_three_slow_sweeps(monkeypatch):
    plane = Tt.TimeSeriesPlane(points=16)
    clock = iter(range(0, 1000, 1))
    monkeypatch.setattr(Tt.time, "perf_counter", lambda: next(clock))
    for r in _reports(Tm, n=5):
        plane.observe(r)
    snap = plane.snapshot()
    assert snap["breaker_tripped"] and snap["steps"] == 3


def _signals(mod, seed=1):
    rs = np.random.RandomState(seed)
    sigs = []
    for s in range(120):
        gn = float(rs.lognormal(0, 0.1))
        nf = 0
        drift = None
        if 20 <= s < 24:
            gn *= 50            # explode
        if 40 <= s < 44:
            gn *= 1e-4          # collapse
        if s in (60, 61, 90):
            nf, gn = 2, float("nan")
        if 70 <= s < 75:
            drift = 0.5
        if s == 80:
            gn = None
        sigs.append(mod.HealthSignal(step=s, grad_norm=gn,
                                     nonfinite_leaves=nf,
                                     fidelity_drift=drift))
    return sigs


def test_health_detector_verdicts_equal_jax():
    jd, td = Jh.HealthDetector(window=8), Th.HealthDetector(window=8)
    jv = [jd.observe(s) for s in _signals(Jh)]
    tv = [td.observe(s) for s in _signals(Th)]
    assert tv == jv
    fired = {f for v in tv for f in v}
    assert fired == set(Th.ANOMALY_CLASSES)


def _health_plane(mod, tmp_path, mmod):
    cfg = types.SimpleNamespace(health=True, nan_guard=True, num_workers=2,
                                health_window=4, health_drift_keys=4)
    mod_flight = Tf if mod is Th else Jf
    mod_flight.configure(dump_dir=str(tmp_path))
    reg = mmod.MetricsRegistry()
    plane = mod.HealthPlane(cfg, reg)
    rs = np.random.RandomState(2)
    out = []
    for s in range(1, 9):
        col = plane.begin_collect(3)
        for i in range(3):
            piece = rs.standard_normal(257).astype(np.float32)
            if s == 6 and i == 1:
                piece[5] = np.nan
            col.leaf(i, piece[:100])
            col.leaf(i, piece[100:])
        col.param_norms_dev = np.array([1.0, 2.0, 4.0], np.float32)
        fields = plane.finalize(col, ["a", "b", "c"], None)
        r = mmod.StepReport(step=s, **fields)
        plane.on_step(r)
        try:
            plane.raise_if_fatal()
            err = None
        except RuntimeError as e:
            err = str(e).split(" — ")[0]
        out.append((fields, r.health_flags, err))
    return out, reg.snapshot()["counters"]


def test_health_plane_collects_and_guards_as_in_jax(tmp_path):
    j = _health_plane(Jh, tmp_path / "j", Jm)
    t = _health_plane(Th, tmp_path / "t", Tm)
    assert t == j
    assert t[0][5][2] is not None and "NAN_GUARD" in t[0][5][2]
    assert t[1]["health/nonfinite_rounds"] == 1


@pytest.mark.parametrize("kind", [
    "TPU v4", "TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v6 lite", "v3",
    "cpu", "", "unknown accelerator"])
def test_detect_peak_equals_jax_on_shared_rows(kind, monkeypatch):
    for v in ("BYTEPS_PEAK_FLOPS", "BYTEPS_PEAK_BW_GBPS"):
        monkeypatch.delenv(v, raising=False)
    assert Tl.detect_peak(kind) == Jl.detect_peak(kind)
    env = {"BYTEPS_PEAK_FLOPS": "2e15", "BYTEPS_PEAK_BW_GBPS": "123"}
    assert Tl.detect_peak(kind, env) == Jl.detect_peak(kind, env)


def test_detect_peak_hopper_rows():
    assert Tl.detect_peak("NVIDIA H100 80GB HBM3") == (989e12, 3350.0,
                                                       "table")
    assert Tl.detect_peak("NVIDIA H100 PCIe") == (756e12, 2000.0, "table")
    assert Tl.device_kind("cpu") == "cpu"


def test_overlap_and_roofline_fractions_equal_jax():
    rs = np.random.RandomState(4)
    for _ in range(200):
        spans = [tuple(sorted(rs.uniform(-0.1, 1.0, 2)))
                 for _ in range(rs.randint(0, 8))]
        end = float(rs.uniform(0, 1))
        assert Tl.overlap_fraction(spans, end) == \
            Jl.overlap_fraction(spans, end)
        args = (rs.choice([None, 0.0, 1e12]), rs.choice([None, 1e9]),
                1e14, 1000.0)
        assert Tl.roofline_fraction(*args) == Jl.roofline_fraction(*args)


def _ledger(lmod, mmod, tmp_path):
    cfg = types.SimpleNamespace(ledger=True, peak_flops=1e14,
                                peak_bw_gbps=1000.0, eff_drop_frac=0.25,
                                eff_drop_window=4, perf_archive="",
                                perf_flush_steps=2)
    reg = mmod.MetricsRegistry()
    led = lmod.EfficiencyLedger(cfg, reg)
    led.register_step_cost(flops=5e12, bytes_accessed=1e10,
                           ideal_wire_bytes=1000, source="x")
    reg.counter("wire/push_bytes").inc(300)
    reg.counter("wire/pull_bytes").inc(500)
    eff = led.step_efficiency(wall_s=0.5, compute_end_s=0.3,
                              wire_spans=[(0.1, 0.4), (0.35, 0.6)],
                              wire_base=100)
    snap = led.snapshot()
    snap.pop("device_kind")
    return eff, snap


def test_efficiency_ledger_prices_a_step_as_in_jax(tmp_path):
    assert _ledger(Tl, Tm, tmp_path) == _ledger(Jl, Jm, tmp_path)


def test_estimate_clock_offset_equals_jax():
    rs = np.random.RandomState(5)
    for _ in range(50):
        samples = []
        for _ in range(rs.randint(1, 6)):
            t0 = int(rs.randint(0, 10 ** 9))
            t1 = t0 + int(rs.randint(-10 ** 6, 10 ** 6))
            t2 = t1 + int(rs.randint(0, 1000))
            samples.append((t0, t1, t2, t0 + (t2 - t1)
                            + int(rs.randint(0, 10 ** 5))))
        assert Tf.estimate_clock_offset(samples) == j_offset(samples)


def _flight(mod, tmp_path):
    mod.configure(capacity=16, dump_dir=str(tmp_path))
    for i in range(20):
        mod.record("wire_retry", key=i, rid=i, detail=f"attempt {i}")
    mod.set_server_collector(lambda: [
        {"server": 0, "offset_ns": 10 ** 12, "err_ns": 5,
         "events": [{"ts_ns": 10 ** 12 + 3, "key": 7, "rid": 1,
                     "sender": 0, "detail": 2, "kind": "replay_dedup"}]}])
    order = []
    mod.add_term_hook(lambda: order.append("archive"))
    mod.add_term_hook(lambda: order.append("ts"),
                      order=mod.TERM_ORDER_TIMESERIES)
    mod.add_term_hook(lambda: 1 / 0)
    mod.run_term_hooks()
    doc = json.load(open(mod.dump(reason="test")))
    return doc, order


def test_flight_record_merges_the_servers_as_in_jax(tmp_path):
    jd, jo = _flight(Jf, tmp_path / "j")
    td, to = _flight(Tf, tmp_path / "t")
    assert to == jo == ["ts", "archive"]
    assert len(td["worker"]["events"]) == 16
    assert td["worker"]["stats"] == jd["worker"]["stats"]
    strip = [{k: v for k, v in e.items() if k != "ts_ns"}
             for e in td["merged"]]
    assert strip == [{k: v for k, v in e.items() if k != "ts_ns"}
                     for e in jd["merged"]]
    srv = [e for e in td["merged"] if e["source"] == "server0"]
    assert srv[0]["ts_ns"] == 3 and srv[0]["kind"] == "replay_dedup"
    assert td["servers"] == jd["servers"]
