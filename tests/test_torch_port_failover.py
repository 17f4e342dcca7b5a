"""Bounded wire retry, server failover and the two-op PUSH/PULL path of
the port, the cases of tests/test_chaos.py on the port's classes:

- the scheduler's retry engine against a fake client: a failing wire
  retries and then succeeds, a spent budget fails fast with a clear
  error, a programming error does not retry;
- ``TensorRegistry.migrate_server`` gives the JAX registry's key ->
  server map on the same declarations, the same on two registries, and
  raises for the last survivor;
- churn: two ``python -m byteps_tpu_torch.server`` processes, one of
  them ended by BYTEPS_CHAOS_KILL_AFTER_ROUNDS inside a round; every
  aggregate (dense leaves and a host-onebit leaf) equals the run without
  churn bit for bit, fused and two-op, with no handle or lease left;
- a dead fleet fails the next round within the retry budget, and the
  error names the flight record's dump;
- dense and host-codec rounds with BYTEPS_FUSED_PUSHPULL=0 equal the
  fused ones.

Every server process is killed in ``finally`` and every wait is bounded.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import byteps_tpu_torch as bps
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.core.scheduler import Handle, PipelineScheduler
from byteps_tpu_torch.core.types import DataType
from byteps_tpu_torch.native.build import build_ps
from byteps_tpu_torch.server.compressed import CompressedRegistry
from _torch_port_ps_util import _free_port, _ps_env, bounded, ps_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _registry(num_servers, partition_bytes=4096, cls=TensorRegistry,
              config=Config):
    return cls(config(num_workers=1, num_servers=num_servers,
                      partition_bytes=partition_bytes))


# --------------------------------------------------------------------- #
# the registry's crash migration
# --------------------------------------------------------------------- #

def _declare_mix(reg, dtype):
    # leaves of 1, 2 and 3 partitions, in one declaration order
    for i in range(7):
        reg.init_tensor(f"m{i}", (1 + i % 3) * 4096 + 4 * i, dtype)


@pytest.mark.parametrize("num_servers,dead", [(2, 1), (3, 1), (4, 2)])
def test_migrate_server_matches_the_jax_registry(num_servers, dead):
    from byteps_tpu.config import Config as JConfig
    from byteps_tpu.core.registry import TensorRegistry as JRegistry
    from byteps_tpu.core.types import DataType as JDataType

    t = _registry(num_servers)
    j = _registry(num_servers, cls=JRegistry, config=JConfig)
    _declare_mix(t, DataType.FLOAT32)
    _declare_mix(j, JDataType.FLOAT32)

    def table(reg):
        return [(p.key, p.server) for ctx in reg.contexts_in_order()
                for p in ctx.partitions]

    assert table(t) == table(j)
    v0 = t.routing_version
    moved = t.migrate_server(dead)
    assert moved == j.migrate_server(dead) and moved
    assert t.routing_version == v0 + 1
    assert table(t) == table(j)
    assert t.server_loads() == j.server_loads()
    assert t.dead_servers() == j.dead_servers() == [dead]
    assert t.alive_servers() == j.alive_servers()
    assert dead not in {s for _, s in table(t)}
    # a new declaration avoids the dead server, as the JAX registry's
    for reg, dt in ((t, DataType.FLOAT32), (j, JDataType.FLOAT32)):
        reg.init_tensor("post", 8 * 4096, dt)
    assert table(t) == table(j)
    assert t.migrate_server(dead) == []     # once per death


def test_migrate_server_is_deterministic_and_raises_for_the_last():
    regs = [_registry(4) for _ in range(2)]
    for reg in regs:
        for i in range(5):
            reg.init_tensor(f"d{i}", 2 * 4096, DataType.FLOAT32)
        reg.migrate_server(2)
    tables = [[(p.key, p.server) for ctx in reg.contexts_in_order()
               for p in ctx.partitions] for reg in regs]
    assert tables[0] == tables[1]
    reg = _registry(2)
    reg.init_tensor("x", 4096, DataType.FLOAT32)
    reg.migrate_server(0)
    with pytest.raises(RuntimeError, match="no surviving server"):
        reg.migrate_server(1)


# --------------------------------------------------------------------- #
# the retry engine against a fake client (no network)
# --------------------------------------------------------------------- #

class _FlakyClient:
    """Fails the first ``fail_n`` sends, then echoes the payload; speaks
    the fused op, and the two-op path's PUSH and PULL."""

    supports_fused = True

    def __init__(self, fail_n):
        self.fail_n = fail_n
        self.calls = 0
        self.epochs = []
        self._last = {}

    def ensure_init(self, ctx, nbytes):
        pass

    def _send(self, key, data, epoch):
        self.calls += 1
        self.epochs.append(epoch)
        if self.calls <= self.fail_n:
            raise RuntimeError("injected wire failure")
        self._last[key] = np.array(np.asarray(data).view(np.uint8))

    def zpushpull_async(self, server, key, data, out, cmd, on_done,
                        epoch=0):
        self._send(key, data, epoch)
        out[:] = self._last[key]
        on_done(len(out), None)

    def zpush_async(self, server, key, data, cmd, epoch=0):
        self._send(key, data, epoch)

    def zpull(self, server, key, out, cmd, exact=False):
        out[:] = self._last[key]
        return len(out)


def _mk_ctx(name="t", nbytes=256):
    return _registry(1, partition_bytes=1 << 20).init_tensor(
        name, nbytes, DataType.FLOAT32)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "two-op"])
def test_scheduler_retries_then_succeeds(monkeypatch, fused):
    monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "3")
    monkeypatch.setenv("BYTEPS_WIRE_BACKOFF_MS", "5")
    client = _FlakyClient(fail_n=2)
    sched = PipelineScheduler(client)
    try:
        assert sched.fused == (fused == "1")
        ctx = _mk_ctx()
        x = np.arange(64, dtype=np.float32)
        h = Handle(0, "t")
        sched.submit(ctx, x, h, average=False, num_workers=1)
        np.testing.assert_array_equal(h.wait(timeout=20), x)
        assert client.calls == 3      # 2 failures, then the success
        # round 1, attempts 0, 1 and 2 in the replay stamp
        assert client.epochs == [(1 << 16) | a for a in range(3)]
        assert sched.counters()["retries"] == 2
    finally:
        sched.stop()


def test_scheduler_retry_budget_fails_fast_with_clear_error(monkeypatch,
                                                             tmp_path):
    from byteps_tpu_torch.core import flight
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "2")
    monkeypatch.setenv("BYTEPS_WIRE_BACKOFF_MS", "5")
    flight.configure(dump_dir=str(tmp_path))
    client = _FlakyClient(fail_n=10 ** 9)    # a wire that never works
    sched = PipelineScheduler(client)
    try:
        h = Handle(0, "dead")
        t0 = time.monotonic()
        sched.submit(_mk_ctx("dead"), np.ones(64, np.float32), h,
                     average=False, num_workers=1)
        with pytest.raises(RuntimeError, match="after 3 attempts") as ei:
            h.wait(timeout=30)
        assert time.monotonic() - t0 < 10, "retry budget not bounded"
        assert client.calls == 3
        assert "flight record dumped to" in str(ei.value)
    finally:
        sched.stop()
        flight.configure(enabled=False)


def test_scheduler_programming_errors_do_not_retry(monkeypatch):
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "5")

    class _BadClient(_FlakyClient):
        def zpushpull_async(self, *a, **kw):
            self.calls += 1
            raise ValueError("caller bug")

    client = _BadClient(fail_n=0)
    sched = PipelineScheduler(client)
    try:
        h = Handle(0, "bug")
        sched.submit(_mk_ctx("bug"), np.ones(8, np.float32), h,
                     average=False, num_workers=1)
        with pytest.raises(ValueError, match="caller bug"):
            h.wait(timeout=20)
        assert client.calls == 1
    finally:
        sched.stop()


class _SlowMigration(TensorRegistry):
    """Holds the failover lock a while after moving the partitions, so a
    second retry reads the route while the migration is half applied
    (its init cache not yet dropped) unless it waits for the lock."""

    def migrate_server(self, dead_server, keys=None):
        moved = super().migrate_server(dead_server, keys)
        time.sleep(0.2)
        return moved


class _FleetClient(_FlakyClient):
    """Two servers; server 1 is dead. Sends to it go out, and their
    replies fail later, the first tensor's after 30 ms, the second's
    after 80 ms, as a dead server's replies fail one by one. A push to a
    key that its server has no store for is refused, and on the two-op
    path that fails the connection, as the native client does."""

    def __init__(self):
        super().__init__(fail_n=0)
        self.inited, self.refused, self.poisoned = set(), [], set()
        self.cache = set()      # keys this client inited, as PSClient's

    def server_dead(self, server):
        return server == 1 or server in self.poisoned

    def ensure_init(self, ctx, nbytes):
        for p in ctx.partitions:
            if p.key not in self.cache:
                self.cache.add(p.key)
                self.inited.add((p.server, p.key))

    def invalidate_init(self, keys):
        self.cache -= set(keys)

    @staticmethod
    def _lost(server):
        return RuntimeError(f"connection to server {server} lost")

    @staticmethod
    def _delay(key):
        return 0.08 if key >> 16 else 0.03

    def _refused(self, server, key):
        if (server, key) in self.inited:
            return False
        self.refused.append(key)
        return True

    def zpushpull_async(self, server, key, data, out, cmd, on_done,
                        epoch=0):
        if self.server_dead(server):
            threading.Timer(self._delay(key), on_done,
                            (0, self._lost(server))).start()
        elif self._refused(server, key):
            on_done(0, RuntimeError(f"push refused key={key}"))
        else:
            super().zpushpull_async(server, key, data, out, cmd, on_done,
                                    epoch)

    def zpush_async(self, server, key, data, cmd, epoch=0):
        if self.server_dead(server):
            return      # its pull fails
        if self._refused(server, key):
            self.poisoned.add(server)
            raise RuntimeError(f"push refused key={key}")
        super().zpush_async(server, key, data, cmd, epoch)

    def zpull(self, server, key, out, cmd, exact=False):
        if self.server_dead(server):
            time.sleep(self._delay(key))
            raise self._lost(server)
        return super().zpull(server, key, out, cmd, exact)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "two-op"])
def test_retries_never_send_to_a_half_applied_migration(monkeypatch, fused):
    """Two tensors with partitions on server 1, which is dead: the first
    tensor's retry migrates every key of server 1 to server 0, and the
    second tensor's partitions, sent before, fail and retry while that
    migration is under way. A retry that read its route before the migration had
    dropped the init cache would push to server 0 without an init (a
    refused push; on the two-op path a failed connection): none does,
    and both rounds land."""
    monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
    monkeypatch.setenv("BYTEPS_WIRE_BACKOFF_MS", "5")
    reg = _SlowMigration(Config(num_workers=1, num_servers=2,
                                partition_bytes=4096))
    ctxs = [reg.init_tensor(f"t{i}", 16 * 4096, DataType.FLOAT32)
            for i in range(2)]
    for ctx in ctxs:
        assert sum(p.server == 1 for p in ctx.partitions) >= 4
    client = _FleetClient()
    sched = PipelineScheduler(client, registry=reg)
    try:
        x = np.arange(16 * 1024, dtype=np.float32)
        hs = [Handle(i, ctx.name) for i, ctx in enumerate(ctxs)]
        for ctx, h in zip(ctxs, hs):
            client.ensure_init(ctx, ctx.nbytes)
            sched.submit(ctx, x, h, average=False, num_workers=1)
        for h in hs:
            np.testing.assert_array_equal(h.wait(timeout=20), x)
        assert client.refused == [] and not client.poisoned
        assert sched.counters()["server_failovers"] == 1
        assert all(p.server == 0 for ctx in ctxs for p in ctx.partitions)
    finally:
        sched.stop()


def test_stop_fails_a_pending_retry(monkeypatch):
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "3")
    monkeypatch.setenv("BYTEPS_WIRE_BACKOFF_MS", "2000")
    sched = PipelineScheduler(_FlakyClient(fail_n=10 ** 9))
    h = Handle(0, "p")
    sched.submit(_mk_ctx("p"), np.ones(8, np.float32), h, average=False,
                 num_workers=1)
    deadline = time.monotonic() + 10
    while sched.counters()["retries"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    sched.stop()
    with pytest.raises(RuntimeError, match="retry still pending"):
        h.wait(timeout=5)


def test_concurrent_flight_dumps_are_whole(tmp_path):
    """Every partition of a failing round dumps the flight record to one
    path at once: each reader finds a whole JSON document."""
    from byteps_tpu_torch.core import flight
    flight.configure(dump_dir=str(tmp_path))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i in range(2048):
            flight.record("wire_retry", key=i, detail="x" * 250)
        paths, errors = [], []

        def dump_and_read(t):
            try:
                # the ring grows between the dumps, as the retries of the
                # other partitions record theirs
                flight.record("round_failed", key=t, detail="y" * (7 * t))
                p = flight.dump(reason="wire-fail-fast")
                with open(p) as f:
                    paths.append((p, json.load(f)["worker"]["stats"]))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=dump_and_read, args=(t,))
                   for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        flight.configure(enabled=False)
    assert not errors, errors
    assert len(paths) == 32
    assert all(st["events"] > 2048 for _, st in paths)
    assert len({p for p, _ in paths}) == 1


# --------------------------------------------------------------------- #
# server processes
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ps_built():
    build_ps()      # once, before any server process starts


def _spawn_server(port, num_workers=1, extra_env=None):
    env = {**os.environ,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
           "DMLC_ROLE": "server", "DMLC_NUM_WORKER": str(num_workers),
           "DMLC_PS_ROOT_PORT": str(port), "BYTEPS_SERVER_ID": "0",
           **(extra_env or {})}
    return subprocess.Popen([sys.executable, "-m", "byteps_tpu_torch.server"],
                            env=env, cwd=REPO)


def _wait_ports(ports, timeout=60):
    deadline = time.monotonic() + timeout
    for port in ports:
        while True:
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=1):
                    break
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"server on {port} never came up")
                time.sleep(0.05)


def _fleet_env(monkeypatch, ports, tmp_path, fused):
    _ps_env(monkeypatch, ports[0])
    monkeypatch.setenv("DMLC_NUM_SERVER", str(len(ports)))
    monkeypatch.setenv("BYTEPS_SERVER_HOSTS",
                       ",".join(f"127.0.0.1:{p}" for p in ports))
    monkeypatch.setenv("BYTEPS_WIRE_BACKOFF_MS", "25")
    monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
    monkeypatch.setenv("BYTEPS_FLIGHT_DIR", str(tmp_path / "flight"))


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


# the churn rounds: 8 dense leaves and one host-onebit leaf, one key each
DENSE_N, COMP_N, ROUNDS = 2048, 4096, 5
ONEBIT = {"compressor": "onebit", "ef": "vanilla"}


def _churn_inputs():
    rs = np.random.RandomState(11)
    return ([rs.randn(DENSE_N).astype(np.float32) for _ in range(8)],
            rs.randn(COMP_N).astype(np.float32))


def _churn_rounds(state, on_round=None):
    """ROUNDS rounds of every leaf, each scaled by its round number + 1;
    ``on_round(r)`` runs after round r's submissions. Returns [(dense
    outputs, compressed output)] per round."""
    grads, cgrad = _churn_inputs()
    reg = CompressedRegistry(state.ps_client, 1, ONEBIT)
    out = []
    for r in range(ROUNDS):
        hs = [bps.push_pull_async(g * (r + 1), f"churn{i}", average=False)
              for i, g in enumerate(grads)]
        ch = reg.push_pull_async(state, "churn_comp", cgrad * (r + 1),
                                 average=False)
        if on_round is not None:
            on_round(r)
        out.append(([np.array(bps.synchronize(h, timeout=60)) for h in hs],
                    np.array(bps.synchronize(ch, timeout=60))))
    return out


def _victim_rounds():
    """Server 1's keys a round, from a registry with the churn run's
    declarations: its chaos kill after 2 rounds plus one key falls in
    round 2, on its first key."""
    reg = _registry(2, partition_bytes=4096000)
    for i in range(8):
        reg.init_tensor(f"churn{i}", DENSE_N * 4, DataType.FLOAT32)
    reg.init_tensor("churn_comp", COMP_N * 4, DataType.FLOAT32)
    owners = [p.server for ctx in reg.contexts_in_order()
              for p in ctx.partitions]
    assert set(owners) == {0, 1}, owners
    return owners.count(1)


@pytest.mark.chaos
@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "two-op"])
def test_server_churn_failover_numerics(ps_built, monkeypatch, tmp_path,
                                        fused):
    """Two server processes; server 1 exits (the SIGKILL shape, no
    teardown) inside round 2 by BYTEPS_CHAOS_KILL_AFTER_ROUNDS. Every
    round's aggregates equal the run without churn bit for bit (one
    worker: the server's sum is the push, and the survivor starts each
    moved key from a new store and the replayed round), the keys of
    server 1 move to server 0, at least one failover happened, and no
    handle or lease is left."""
    from byteps_tpu_torch.core import flight

    # the run without churn: one server thread
    monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            want = bounded(lambda: _churn_rounds(bps.get_state()))
        finally:
            bps.shutdown()

    per_round = _victim_rounds()
    ports = []
    while len(ports) < 2:
        p = _free_port()
        if p not in ports:
            ports.append(p)
    _fleet_env(monkeypatch, ports, tmp_path, fused)
    # one partition in flight at a time: server 1's later keys of round 2
    # are still queued when its death migrates them, and their first
    # send goes to server 0
    monkeypatch.setenv("BYTEPS_SCHEDULING_CREDIT", str(DENSE_N * 4))
    # a retry budget that outlasts a loaded host's sight of the killed
    # server's EOF (25 ms doubling, capped at 2 s: about 5.2 s in all;
    # the default 2 retries give 75 ms, which a loaded host can spend
    # re-sending to the dead server before its connections read dead)
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "8")
    procs = [_spawn_server(ports[0]), _spawn_server(
        ports[1], extra_env={"BYTEPS_CHAOS_KILL_AFTER_ROUNDS":
                             str(2 * per_round + 1)})]
    try:
        _wait_ports(ports)
        bps.init(device="cpu")
        state = bps.get_state()
        try:
            got = bounded(lambda: _churn_rounds(state))
            c = state.scheduler.counters()
            assert procs[1].wait(timeout=10) == 137   # the chaos exit
            assert c["server_failovers"] >= 1 and c["retries"] >= 1
            assert c["key_migrations"] == per_round
            assert state.registry.dead_servers() == [1]
            assert all(p.server == 0
                       for ctx in state.registry.contexts_in_order()
                       for p in ctx.partitions)
            kinds = [e["kind"] for e in flight.get_recorder().events()]
            for kind in ("wire_retry", "server_failover", "key_migration"):
                assert kind in kinds, kinds
            # nothing left: handles cleared, no arena slot leased
            assert not state.handles._handles
            with state.arena._mu:
                assert not [k for k, s in state.arena._slots.items()
                            if s.busy]
        finally:
            bounded(bps.shutdown)
        assert procs[0].wait(timeout=20) == 0     # SHUTDOWN reached it
    finally:
        _kill(procs)
    grads, cgrad = _churn_inputs()
    for r, ((dense, comp), (w_dense, w_comp)) in enumerate(zip(got, want)):
        for i, (o, w, g) in enumerate(zip(dense, w_dense, grads)):
            np.testing.assert_array_equal(o, w, err_msg=f"{r} churn{i}")
            np.testing.assert_array_equal(o, g * (r + 1))
        np.testing.assert_array_equal(comp, w_comp, err_msg=f"{r} comp")


@pytest.mark.chaos
def test_dead_fleet_fails_fast_with_the_flight_dump(ps_built, monkeypatch,
                                                   tmp_path):
    port = _free_port()
    _fleet_env(monkeypatch, [port], tmp_path, "1")
    monkeypatch.setenv("BYTEPS_WIRE_RETRY", "2")
    proc = _spawn_server(port)
    try:
        _wait_ports([port])
        bps.init(device="cpu")
        try:
            x = np.ones(512, np.float32)
            out = bps.synchronize(bps.push_pull_async(x, "ff", False),
                                  timeout=30)
            np.testing.assert_array_equal(out, x)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
            t0 = time.monotonic()
            h = bps.push_pull_async(x * 2, "ff", average=False)
            with pytest.raises(RuntimeError) as ei:
                bps.synchronize(h, timeout=30)
            assert time.monotonic() - t0 < 30
            msg = str(ei.value)
            assert "flight record dumped to" in msg, msg
            path = msg.rsplit("flight record dumped to ", 1)[1].strip()
            assert path.startswith(str(tmp_path))
            with open(path) as f:
                kinds = [e["kind"] for e in json.load(f)["worker"]["events"]]
            assert "wire_retry" in kinds and "round_failed" in kinds, kinds
        finally:
            bounded(bps.shutdown)
    finally:
        _kill([proc])


def _two_op_rounds(monkeypatch, fused):
    """Two rounds of three dense leaves and a host-onebit leaf through a
    loopback server, fused or two-op; returns the outputs and the wire
    ops each took."""
    monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
    rs = np.random.RandomState(5)
    xs = [rs.randn(n).astype(np.float32) for n in (1000, 70000, 3)]
    cx = rs.randn(9000).astype(np.float32)
    calls = {"pushpull": 0, "push": 0, "pull": 0}
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "65536")
        bps.init(device="cpu")
        try:
            state = bps.get_state()
            client = state.ps_client
            for name, op in (("pushpull", "zpushpull_async"),
                             ("push", "zpush_async"), ("pull", "zpull")):
                def counted(*a, _f=getattr(client, op), _n=name, **kw):
                    calls[_n] += 1
                    return _f(*a, **kw)
                setattr(client, op, counted)
            reg = CompressedRegistry(client, 1, ONEBIT, 4096)

            def run():
                outs = []
                for r in range(2):
                    hs = [bps.push_pull_async(x * (r + 1), f"two{i}")
                          for i, x in enumerate(xs)]
                    ch = reg.push_pull_async(state, "two_comp", cx * (r + 1))
                    outs.append([bps.synchronize(h, timeout=30)
                                 for h in hs + [ch]])
                return outs

            return bounded(run), calls, state.scheduler.fused
        finally:
            bps.shutdown()


def test_two_op_rounds_equal_the_fused_ones(monkeypatch):
    fused, f_calls, f_on = _two_op_rounds(monkeypatch, "1")
    two, t_calls, t_on = _two_op_rounds(monkeypatch, "0")
    assert f_on and not t_on
    assert f_calls["push"] == f_calls["pull"] == 0 < f_calls["pushpull"]
    assert t_calls["pushpull"] == 0
    assert t_calls["push"] == t_calls["pull"] == f_calls["pushpull"]
    for r, (a, b) in enumerate(zip(fused, two)):
        for i, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(x, y, err_msg=f"round {r} #{i}")
