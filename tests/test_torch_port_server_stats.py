"""The port's server stats mirror and fleet knobs against the JAX
package's:

- both packages parse the stats slots of the port's build of ``ps.cc``
  alike (``parse_stat_slots``, ``derive_stage_section``,
  ``parse_health_rec``), and the loaded library's slot names are
  ``_STAT_SLOTS``;
- after rounds through a loopback server, its STATS_PULL reply over the
  wire equals the in-process mirror, slot for slot, the ``fleet``
  section reads it (``source`` "wire"), and HEALTH_PULL equals
  ``key_health``;
- a server started by either package's ``run_server`` passes the same
  async, schedule and debug-key flags to ``bps_server_create_dbg``
  (BYTEPS_SERVER_ENABLE_SCHEDULE, BYTEPS_SERVER_DEBUG(_KEY));
- BYTEPS_STAGING_ARENA=0: a PS step with fresh buffers equals the step
  with the arena bit for bit, and ``get_arena_stats()`` says which ran;
- with two servers and one worker the fleet section has both, and their
  folded bytes sum to the worker's ``wire/push_bytes`` (the relation
  ``chip_smoke.py``'s observability phase holds on the card).
"""

import struct

import numpy as np
import pytest
import torch

import byteps_tpu.server as jserver
import byteps_tpu_torch as bps
import byteps_tpu_torch.server as tserver
from byteps_tpu_torch.models import mlp
from byteps_tpu_torch.training import make_ps_train_step
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import ps_lib  # noqa: F401


def test_slot_layouts_equal_jax(ps_lib):
    assert tserver._STAT_SLOTS == jserver._STAT_SLOTS
    assert tserver.native_stat_slot_names() == list(tserver._STAT_SLOTS)
    for name in ("TRACE_REC_FMT", "FLIGHT_REC_FMT", "HEALTH_REC_FMT",
                 "STRIPE_REC_FMT", "_FLIGHT_REC_FIELDS",
                 "_HEALTH_REC_FIELDS", "_STRIPE_REC_FIELDS",
                 "FLIGHT_KIND_NAMES"):
        assert getattr(tserver, name) == getattr(jserver, name), name
    assert tserver.native_stripe_field_names() == \
        list(tserver._STRIPE_REC_FIELDS)


def test_parsers_equal_jax():
    rs = np.random.RandomState(0)
    n = len(tserver._STAT_SLOTS)
    for k in (n - 3, n, n + 4):        # an older, the same, a newer server
        vec = [int(x) for x in rs.randint(0, 1 << 40, k)]
        raw = struct.pack(f"<{k}Q", *vec)
        for src in (vec, raw):
            got = tserver.parse_stat_slots(src)
            assert got == jserver.parse_stat_slots(src)
            assert tserver.derive_stage_section(got) == \
                jserver.derive_stage_section(got)
    rec = struct.pack(tserver.HEALTH_REC_FMT, 9, 3,
                      *struct.unpack("<2Q", struct.pack("<2d", 4.5, -1.25)),
                      2, 100)
    assert tserver.parse_health_rec(rec) == jserver.parse_health_rec(rec)
    assert tserver.parse_health_rec(rec)["sumsq"] == 4.5
    assert tserver.parse_health_rec(rec[:-1]) is None


def test_stats_pull_equals_the_in_process_mirror(ps_lib, monkeypatch):
    monkeypatch.setenv("BYTEPS_HEALTH", "1")   # the server's in-fold pass
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            x = np.arange(4096, dtype=np.float32)
            for _ in range(3):
                bounded(lambda: bps.synchronize(
                    bps.push_pull_async(x, "grad/x", average=False)))
            st = bps.get_state()
            client = st.ps_client
            assert tserver._live, "the loopback server is in process"
            wire = bounded(lambda: client.server_stats(0))
            local = tserver.per_server_stats()
            assert len(local) == 1 and wire == local[0]
            assert wire["fold_bytes"] > 0 and wire["recv_count"] >= 3
            fleet = bps.get_fleet_metrics()["fleet"]
            assert fleet["source"] == "wire" and list(fleet["server"]) == \
                ["0"]
            assert fleet["server"]["0"] == tserver.derive_stage_section(wire)
            ctx = st.registry.get("grad/x")
            key = ctx.partitions[0].key
            rec = bounded(lambda: client.health_pull(0, key))
            assert rec == tserver.key_health(key)
            np.testing.assert_allclose(rec["sumsq"],
                                       float(np.dot(x.astype(np.float64),
                                                    x)), rtol=1e-6)
            assert bps.get_metrics()["server"]["live"] == 1
        finally:
            bps.shutdown()


class _FakeLib:
    """Stands in for the loaded ``ps.cc``: records the server's creation
    arguments, and its serve loop returns at once."""

    def __init__(self):
        self.created = None

        def create(*args):
            self.created = args
            return 1

        self.bps_server_create_dbg = _Fn(create)
        self.bps_server_run = _Fn(lambda srv: 0)
        self.bps_server_destroy = _Fn(lambda srv: None)


class _Fn:
    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *a):
        return self.fn(*a)


@pytest.mark.parametrize("env,want", [
    ({}, (0, 0, -1)),
    ({"BYTEPS_SERVER_ENABLE_SCHEDULE": "1"}, (0, 1, -1)),
    ({"BYTEPS_SERVER_DEBUG": "1", "BYTEPS_SERVER_DEBUG_KEY": "17"},
     (0, 0, 17)),
    ({"BYTEPS_SERVER_DEBUG": "on"}, (0, 0, 0)),
    ({"BYTEPS_ENABLE_ASYNC": "2", "BYTEPS_SERVER_ENABLE_SCHEDULE": "yes",
      "BYTEPS_SERVER_DEBUG": "0", "BYTEPS_SERVER_DEBUG_KEY": "5"},
     (1, 1, -1)),
], ids=["default", "schedule", "debug-key", "debug-key-0", "async"])
def test_run_server_passes_the_flags_jax_passes(env, want, monkeypatch):
    for v in ("BYTEPS_SERVER_ENABLE_SCHEDULE", "BYTEPS_SERVER_DEBUG",
              "BYTEPS_SERVER_DEBUG_KEY", "BYTEPS_ENABLE_ASYNC"):
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    created = []
    for mod, build in ((jserver, "build"), (tserver, "build_ps")):
        lib = _FakeLib()
        monkeypatch.setattr(mod, build, lambda *a, **k: "unused.so")
        monkeypatch.setattr(mod.ctypes, "CDLL", lambda path: lib)
        assert mod.run_server(port=1234) == 0
        created.append(lib.created)
    assert created[0] == created[1]
    assert created[1][3:] == want
    assert created[1][0] == 1234


def _arena_run(monkeypatch, arena: str):
    monkeypatch.setenv("BYTEPS_STAGING_ARENA", arena)
    monkeypatch.setenv("BYTEPS_FUSION_BYTES", "4096")
    cfg = mlp.MLPConfig(in_dim=64, hidden=(48, 32), n_classes=10)
    model = mlp.MLP(cfg, "cpu", params=mlp.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    rs = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rs.rand(32, 64).astype(np.float32)),
             "y": torch.from_numpy(rs.randint(0, 10, 32).astype(np.int64))}
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            step = make_ps_train_step(
                lambda b: mlp.loss_fn(model.params(), b, cfg),
                torch.optim.Adam(model.parameters(), lr=1e-2),
                model.params())
            losses = bounded(lambda: [float(step(batch)) for _ in range(3)])
            bounded(step.close)
            stats = bps.get_arena_stats()
        finally:
            bps.shutdown()
    return ({n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}, losses, stats)


def test_arena_off_step_equals_the_arena_step(ps_lib, monkeypatch):
    on, on_losses, on_stats = _arena_run(monkeypatch, "1")
    off, off_losses, off_stats = _arena_run(monkeypatch, "0")
    assert off_losses == on_losses
    for n, a in on.items():
        np.testing.assert_array_equal(off[n], a, err_msg=n)
    assert on_stats["enabled"] and on_stats["allocs_avoided"] > 0
    assert not off_stats["enabled"]
    assert off_stats["slots_live"] == off_stats["allocs_avoided"] == 0
    assert off_stats["fresh_allocs"] > 0
    assert off_stats["export_rounds"] == on_stats["export_rounds"] == 3


def test_fleet_fold_bytes_are_the_pushed_bytes(ps_lib, monkeypatch):
    """Two servers of one worker: the fleet section has an entry a
    server, over the wire, and the servers' folded bytes sum to the
    worker's ``wire/push_bytes`` (every payload is folded once), dense
    and under host onebit."""
    import threading

    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.server import run_server
    from _torch_port_ps_util import _free_port
    ports = [_free_port(), _free_port()]
    servers = [threading.Thread(target=run_server, args=(
        p, Config(num_workers=1, num_servers=2)), daemon=True)
        for p in ports]
    for t in servers:
        t.start()
    _ps_env(monkeypatch, ports[0])
    monkeypatch.setenv("DMLC_NUM_SERVER", "2")
    monkeypatch.setenv("BYTEPS_SERVER_HOSTS",
                       ",".join(f"127.0.0.1:{p}" for p in ports))
    monkeypatch.setenv("BYTEPS_FUSION_BYTES", "4096")
    cfg = mlp.MLPConfig(in_dim=64, hidden=(256, 128), n_classes=10)
    model = mlp.MLP(cfg, "cpu", params=mlp.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    batch = {"x": torch.ones(8, 64), "y": torch.zeros(8, dtype=torch.int64)}

    def totals():
        snap = bps.get_fleet_metrics()
        fleet = snap["fleet"]
        assert fleet["source"] == "wire" and sorted(fleet["server"]) == \
            ["0", "1"]
        return (sum(s["fold_bytes"] for s in fleet["server"].values()),
                snap["counters"]["wire/push_bytes"])

    bps.init(device="cpu")
    try:
        for kw in ({}, dict(compression={"compressor": "onebit",
                                         "ef": "vanilla"},
                            device_compress=False, min_compress_bytes=4096)):
            step = make_ps_train_step(
                lambda b: mlp.loss_fn(model.params(), b, cfg),
                torch.optim.SGD(model.parameters(), lr=0.1),
                model.params(), **kw)
            fold0, push0 = totals()
            bounded(lambda: [step(batch) for _ in range(2)])
            bounded(step.close)
            fold1, push1 = totals()
            assert push1 > push0
            assert fold1 - fold0 == push1 - push0
    finally:
        bps.shutdown()
    for t in servers:
        t.join(10)
        assert not t.is_alive()
