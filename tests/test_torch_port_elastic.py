"""The port's elastic PS fleet against the JAX package's
(``core/registry.py`` plans, ``core/elastic.py``, ``suspend``/``resume``).

- the registry plans: over seeded declaration histories (sizes, row-sparse
  alignments, a freed key, shard keys, 2-4 servers, the djb2 and the
  least-loaded "mixed" assignment) the port's ``plan_join``,
  ``plan_drain``, ``rebalance`` and ``redeclare_all`` give the JAX
  ``TensorRegistry``'s moves and routing table after them; a stale plan
  is refused by both, draining the last survivor raises in both, and
  ``redeclare_all`` advances the routing version;
- a fleet on ``ps.cc``: ``join_probe`` reports the worker count; a
  newcomer run for another worker count is refused, its slot is retired
  unused, and the next join aligns; the moved keys' next round is the
  sum of the round before;
- Llama ``tiny()`` on the dense host tier across a join after step 1, a
  drain after step 2 and a suspend/resume with another server count
  after step 3 ends bit for bit where the same steps with no event end,
  and so does the row-sparse wire; so do the adapter's
  ``DistributedOptimizer`` and ``DistributedDataParallel`` across a
  suspend/resume, and a round started before the suspend raises;
- moved compressed keys, the port against the JAX package on an MLP: on
  the host-codec tier both self-heal in one retried round of the same
  keys and agree at the dense tolerance; on the PS device tier both
  refuse the moved keys' compressed pushes (ROADMAP.md §C);
- a mixed fleet: a JAX worker and a port worker in a spawned process
  join one server at the same round boundary, compute the same plan and
  get the same aggregate after it.
"""

import dataclasses
import multiprocessing as mp
import os
import threading

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
import byteps_tpu_torch.torch as bpt
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core import flight
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.core.types import DataType
from byteps_tpu_torch.server import run_server
from byteps_tpu_torch.server.client import PSClient
from _torch_port_ps_util import _free_port, _ps_env, bounded
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401


@pytest.fixture(autouse=True)
def _restored_env():
    """The environment as it was before the test: the elastic calls and
    ``resume`` write the fleet's topology into ``os.environ``
    (DMLC_NUM_SERVER, BYTEPS_SERVER_HOSTS, BYTEPS_RETIRED_SERVERS,
    BYTEPS_GLOBAL_RANK), and a later test in the process must not read
    it."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


# --------------------------------------------------------------------- #
# the registry plans against the JAX registry's
# --------------------------------------------------------------------- #

PART = 8192

# (seed, servers, hash)
HISTORIES = [(0, 2, "djb2"), (1, 3, "djb2"), (2, 4, "djb2"),
             (3, 2, "mixed"), (4, 3, "mixed"), (5, 4, "mixed")]


def _history(seed: int):
    """A seeded declaration history: (op, name, nbytes, align) in order,
    with row-sparse tensors, shard keys and a freed, re-declared name."""
    rs = np.random.RandomState(seed)
    ops = []
    for i in range(12):
        kind = rs.randint(4)
        if kind == 0:
            width = int(rs.choice([16, 48, 130]))
            rows = int(rs.randint(8, 200))
            ops.append(("init", f"t{i}/rows", rows * width * 4, width * 4))
        elif kind == 1:
            ops.append(("shards", f"t{i}/leaf", int(rs.randint(1, 6000)) * 4,
                        int(rs.randint(2, 5))))
        else:
            ops.append(("init", f"t{i}", int(rs.randint(1, 12000)) * 4,
                        None))
    ops.insert(6, ("free", ops[2][1] if ops[2][0] == "init" else ops[3][1],
                   0, None))
    ops.append(("init", ops[6][1], int(rs.randint(1, 9000)) * 4, None))
    return ops


def _replay_history(reg, ops, dtype) -> None:
    for op, name, nbytes, extra in ops:
        if op == "init":
            reg.init_tensor(name, nbytes, dtype, align_bytes=extra)
        elif op == "shards":
            reg.declare_shards(name, nbytes, extra, dtype)
        else:
            reg.free(name)


def _table(reg):
    return [(c.name, c.declared_key,
             [(p.key, p.offset, p.length, p.server) for p in c.partitions])
            for c in reg.contexts_in_order()]


def _moves(plan):
    return [(m.key, m.src, m.dst, m.length) for m in plan.moves]


def _same(port, jax_reg):
    assert _table(port) == _table(jax_reg)
    assert port.server_loads() == jax_reg.server_loads()
    assert port.dead_servers() == jax_reg.dead_servers()
    assert port.routing_version == jax_reg.routing_version


@pytest.mark.parametrize("seed,servers,fn", HISTORIES,
                         ids=[f"{f}-{n}srv-s{s}" for s, n, f in HISTORIES])
def test_registry_plans_match_jax(seed, servers, fn):
    from byteps_tpu.config import Config as JConfig
    from byteps_tpu.core import types as jtypes
    from byteps_tpu.core.registry import TensorRegistry as JRegistry

    ops = _history(seed)
    port = TensorRegistry(Config(num_servers=servers, partition_bytes=PART,
                                 key_hash_fn=fn))
    jreg = JRegistry(JConfig(num_servers=servers, partition_bytes=PART,
                             key_hash_fn=fn))
    _replay_history(port, ops, DataType.FLOAT32)
    _replay_history(jreg, ops, jtypes.DataType.FLOAT32)
    _same(port, jreg)
    # a join: the newcomer takes the earliest-declared partitions of the
    # most-loaded servers up to its share
    idx = port.add_server()
    assert idx == jreg.add_server() == servers
    pj, jj = port.plan_join(idx), jreg.plan_join(idx)
    assert _moves(pj) == _moves(jj) and pj.moves
    assert pj.keys() == jj.keys()
    assert port.rebalance(pj) == jreg.rebalance(jj)
    _same(port, jreg)
    assert port.server_loads()[idx] > 0
    # a drain: every partition of the server to the least-loaded
    # survivors; a plan computed before another change is stale
    victim = int(np.random.RandomState(seed).randint(servers))
    other = (victim + 1) % (servers + 1)
    pd, jd = port.plan_drain(victim), jreg.plan_drain(victim)
    stale_p, stale_j = port.plan_drain(other), jreg.plan_drain(other)
    assert _moves(pd) == _moves(jd) and pd.retire and jd.retire
    assert port.rebalance(pd) == jreg.rebalance(jd)
    _same(port, jreg)
    assert port.server_loads()[victim] == 0
    for reg, plan in ((port, stale_p), (jreg, stale_j)):
        with pytest.raises(RuntimeError, match="stale rebalance plan"):
            reg.rebalance(plan)
    _same(port, jreg)
    # a resume onto fewer servers, the drained slot kept retired
    version = port.routing_version
    keep = servers if victim < servers else servers - 1
    port.redeclare_all(Config(num_servers=keep, partition_bytes=PART,
                              key_hash_fn=fn, retired_servers=(victim,)))
    jreg.redeclare_all(JConfig(num_servers=keep, partition_bytes=PART,
                               key_hash_fn=fn, retired_servers=(victim,)))
    assert port.routing_version == version + 1
    _same(port, jreg)
    # the next init_tensor of each re-partitions it, in either package
    _replay_history(port, [o for o in ops if o[0] == "init"],
                    DataType.FLOAT32)
    _replay_history(jreg, [o for o in ops if o[0] == "init"],
                    jtypes.DataType.FLOAT32)
    _same(port, jreg)


def test_draining_the_last_survivor_raises_in_both():
    from byteps_tpu.config import Config as JConfig
    from byteps_tpu.core import types as jtypes
    from byteps_tpu.core.registry import TensorRegistry as JRegistry

    regs = [(TensorRegistry(Config(num_servers=2)), DataType.FLOAT32),
            (JRegistry(JConfig(num_servers=2)), jtypes.DataType.FLOAT32)]
    for reg, dt in regs:
        reg.init_tensor("a", 1 << 20, dt)
        reg.rebalance(reg.plan_drain(0))
        with pytest.raises(RuntimeError, match="already retired"):
            reg.plan_drain(0)
        with pytest.raises(RuntimeError, match="no other surviving"):
            reg.plan_drain(1)
        # the JAX check raises an AssertionError (bps_check), the port's
        # a RuntimeError, as its other registry checks do
        with pytest.raises((RuntimeError, AssertionError), match="retired"):
            reg.plan_join(0)
    assert _table(regs[0][0]) == _table(regs[1][0])


# --------------------------------------------------------------------- #
# a fleet on ps.cc
# --------------------------------------------------------------------- #

def _serve(port, num_workers=1, **cfg):
    t = threading.Thread(target=run_server, args=(port, Config(
        num_workers=num_workers, num_servers=1, **cfg)), daemon=True)
    t.start()
    return t


def _fleet_env(monkeypatch, ports, num_workers=1):
    _ps_env(monkeypatch, ports[0], num_workers)
    monkeypatch.setenv("DMLC_NUM_SERVER", str(len(ports)))
    monkeypatch.setenv("BYTEPS_SERVER_HOSTS",
                       ",".join(f"127.0.0.1:{p}" for p in ports))
    monkeypatch.delenv("BYTEPS_RETIRED_SERVERS", raising=False)
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", str(PART))


def test_join_probe_refuses_a_wrong_worker_count_and_realigns(
        ps_lib, monkeypatch):
    p0, bad, good = _free_port(), _free_port(), _free_port()
    servers = [_serve(p0), _serve(bad, num_workers=2), _serve(good)]
    _fleet_env(monkeypatch, [p0])
    rs = np.random.RandomState(3)
    xs = {f"j/{i}": rs.randn(int(n)).astype(np.float32)
          for i, n in enumerate((5000, 3000, 9000, 100))}
    bps.init(device="cpu")
    try:
        state = bps.get_state()

        def body():
            first = {k: bps.push_pull(torch.from_numpy(x), name=k).numpy()
                     for k, x in xs.items()}
            assert state.ps_client.join_probe(0) == {"num_workers": 1,
                                                     "draining": False}
            with pytest.raises(RuntimeError, match="num_workers=2"):
                bps.add_server(f"127.0.0.1:{bad}")
            # the slot is accounted for and retired: the next join is 2
            assert state.registry.dead_servers() == [1]
            assert os.environ["BYTEPS_RETIRED_SERVERS"] == "1"
            assert bps.add_server(f"127.0.0.1:{good}") == 2
            loads = state.registry.server_loads()
            assert loads[1] == 0 and loads[2] > 0
            second = {k: bps.push_pull(torch.from_numpy(x), name=k).numpy()
                      for k, x in xs.items()}
            return first, second

        first, second = bounded(body)
        kinds = [e["kind"] for e in flight.get_recorder().events()]
        assert "server_join" in kinds and "key_migration" in kinds
        assert os.environ["BYTEPS_SERVER_HOSTS"].split(",") == [
            f"127.0.0.1:{p}" for p in (p0, bad, good)]
        for k, x in xs.items():
            np.testing.assert_array_equal(first[k], x)
            np.testing.assert_array_equal(second[k], x)
    finally:
        bps.shutdown()
    # the refused server waits for a second worker's SHUTDOWN
    PSClient([f"127.0.0.1:{bad}"], 1).close()
    for t in servers:
        t.join(10)
        assert not t.is_alive()


def test_resume_refuses_a_short_host_list_before_touching_the_env(
        ps_lib, monkeypatch):
    p0 = _free_port()
    server = _serve(p0)
    _fleet_env(monkeypatch, [p0])
    bps.init(device="cpu")
    try:
        bps.suspend()
        before = dict(os.environ)
        with pytest.raises(ValueError, match="names only 1"):
            bps.resume(1, 2)
        assert dict(os.environ) == before
        with pytest.raises(RuntimeError, match="while suspended"):
            bps.init(device="cpu")
        bps.resume(1, 1, global_rank=0)
        assert bps.get_state().config.global_rank == 0
    finally:
        bps.shutdown()
    server.join(10)
    assert not server.is_alive()


TINY_STEPS = 5


def _tiny():
    from byteps_tpu_torch.models import llama as tl
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=64, seq=32),
                              dtype=torch.float32)
    rs = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(
        rs.randint(0, 64, (2, 33)).astype(np.int64))}
    return cfg, batch


def _tiny_run(monkeypatch, events: bool, tier: str = "host"):
    """TINY_STEPS dense steps of tiny() (Adam) from one seed against two
    servers; with ``events`` a third server joins after step 1, server 0
    is drained after step 2, and after step 3 a suspend and a resume onto
    the first two servers (the drained one still retired, so one live
    server holds every key). ``tier``: "host" (``make_ps_train_step``),
    "rowsparse" (the embedding row-sparse), "adapter"
    (``DistributedOptimizer``) or "ddp" (``DistributedDataParallel``),
    the last two across the suspend/resume alone. Returns the losses,
    the parameters and what the events left."""
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import make_ps_train_step
    cfg, batch = _tiny()
    model = tl.Llama(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    ports = [_free_port() for _ in range(3)]
    servers = [_serve(p) for p in ports]
    _fleet_env(monkeypatch, ports[:2])
    monkeypatch.setenv("BYTEPS_FUSION_BYTES", "4096")
    seen = {}
    bps.init(device="cpu")
    try:
        if tier == "adapter":
            opt = bpt.DistributedOptimizer(
                torch.optim.Adam(model.parameters(), lr=1e-3),
                named_parameters=model.named_parameters())

            def step(b):
                opt.zero_grad()
                loss = tl.loss_fn(model.params(), b, cfg)
                loss.backward()
                opt.step()
                return loss.detach()
            step.flush = step.close = lambda: None
        elif tier == "ddp":
            ddp = bpt.DistributedDataParallel(model)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)

            def step(b):
                opt.zero_grad()
                loss = tl.loss_fn(model.params(), b, cfg)
                loss.backward()
                ddp.sync_gradients()
                opt.step()
                return loss.detach()
            step.flush = step.close = lambda: None
        else:
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg),
                torch.optim.Adam(model.parameters(), lr=1e-3),
                model.params(),
                rowsparse_params=("embed",) if tier == "rowsparse" else None)

        def run():
            losses = []
            for i in range(TINY_STEPS):
                losses.append(float(step(batch)))
                if not events:
                    continue
                state = bps.get_state()
                if i == 0 and tier in ("host", "rowsparse"):
                    seen["join"] = bps.add_server(f"127.0.0.1:{ports[2]}")
                    seen["join_load"] = state.registry.server_loads()[2]
                if i == 1 and tier in ("host", "rowsparse"):
                    seen["drained"] = len(bps.drain_server(0))
                    seen["drain_load"] = state.registry.server_loads()[0]
                    seen["kinds"] = {e["kind"] for e in
                                     flight.get_recorder().events()}
                if i == 2:
                    step.flush()
                    surface = bpt if tier in ("adapter", "ddp") else bps
                    surface.suspend()
                    surface.resume(1, 2)
                    seen["resumed"] = (
                        bps.get_state().registry.server_loads(),
                        bps.get_state().registry.dead_servers())
            return losses

        losses = bounded(run, timeout=120)
        step.close()
    finally:
        bps.shutdown()
    # the third server: never connected, or left by the resume
    PSClient([f"127.0.0.1:{ports[2]}"], 0).close()
    for t in servers:
        t.join(10)
        assert not t.is_alive()
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}, seen


@pytest.mark.parametrize("tier", ["host", "rowsparse", "adapter", "ddp"])
def test_tiny_steps_across_fleet_events_equal_the_steps_without(
        ps_lib, monkeypatch, tier):
    base = _tiny_run(monkeypatch, False, tier)
    got = _tiny_run(monkeypatch, True, tier)
    assert got[0] == base[0]
    for n, p in base[1].items():
        assert torch.equal(got[1][n], p), n
    seen = got[2]
    if tier in ("host", "rowsparse"):
        assert seen["join"] == 2 and seen["join_load"] > 0
        assert seen["drained"] > 0 and seen["drain_load"] == 0
        assert {"server_join", "server_drain",
                "key_migration"} <= seen["kinds"]
        # resumed onto servers 0 and 1, server 0 still retired
        loads, dead = seen["resumed"]
        assert dead == [0] and loads[0] == 0 and loads[1] > 0


@pytest.mark.parametrize("surface", ["push_pull_async", "adapter"])
def test_a_round_in_flight_at_the_suspend_raises(ps_lib, monkeypatch,
                                                 surface):
    """A round parked on the server (a fleet of two workers; the second
    makes the key's init, the barrier, and never pushes) fails at the
    suspend: ``synchronize`` or the adapter's ``step()`` raises at once
    instead of waiting for it."""
    from byteps_tpu_torch.core.types import RequestType, get_command_type
    p0 = _free_port()
    server = _serve(p0, num_workers=2)
    _fleet_env(monkeypatch, [p0], num_workers=2)
    peer = PSClient([f"127.0.0.1:{p0}"], 1)
    bps.init(device="cpu")
    try:
        state = bps.get_state()
        name = "park/x" if surface == "push_pull_async" else "grad/w"
        ctx = state.registry.init_tensor(name, 4096 * 4, DataType.FLOAT32)
        cmd = get_command_type(RequestType.DEFAULT_PUSH_PULL, ctx.dtype)

        def body():
            t = threading.Thread(target=lambda: [peer.init_key(
                p.server, p.key, np.zeros(p.length, np.uint8), cmd)
                for p in ctx.partitions])
            t.start()
            state.ps_client.ensure_init(ctx, 4096 * 4)
            t.join()
            if surface == "push_pull_async":
                h = bps.push_pull_async(np.ones(4096, np.float32), name)
                bps.suspend()
                with pytest.raises(RuntimeError):
                    bps.synchronize(h)
                return
            w = torch.nn.Parameter(torch.ones(4096))
            opt = bpt.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                           named_parameters=[("w", w)])
            (w * w).sum().backward()
            bpt.suspend()
            with pytest.raises(RuntimeError):
                opt.step()
            assert torch.equal(w.detach(), torch.ones(4096))

        bounded(body, timeout=30)
    finally:
        bps.shutdown()
    # the suspend sent no SHUTDOWN: worker 0's and the peer's
    PSClient([f"127.0.0.1:{p0}"], 0).close()
    peer.close()
    server.join(10)
    assert not server.is_alive()


# --------------------------------------------------------------------- #
# moved compressed keys, against the JAX package
# --------------------------------------------------------------------- #

ONEBIT = {"compressor": "onebit", "ef": "vanilla"}
MLP_LR, MLP_MU = 0.05, 0.9


def _mlp_setup():
    from byteps_tpu_torch.models import mlp
    cfg = mlp.MLPConfig(in_dim=64, hidden=(48, 32), n_classes=10)
    init = {k: v.numpy() for k, v in mlp.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").items()}
    rs = np.random.RandomState(0)
    batch = {"x": rs.rand(32, 64).astype(np.float32),
             "y": rs.randint(0, 10, 32).astype(np.int32)}
    return cfg, init, batch


def _codec_env(monkeypatch, tmp_path, ports):
    _fleet_env(monkeypatch, ports[:1])
    for k, v in {"BYTEPS_MIN_COMPRESS_BYTES": "4096",
                 "BYTEPS_FUSION_BYTES": "4096",
                 "BYTEPS_STREAM_EXPORT": "0",
                 "BYTEPS_WIRE_BACKOFF_MS": "5", "BYTEPS_LEDGER": "0",
                 "BYTEPS_FLIGHT_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)


def _events(recorder, kind):
    return sorted({e["key"] for e in recorder.events() if e["kind"] == kind})


def _port_through_join(monkeypatch, tmp_path, device_compress):
    """One onebit + EF step of the MLP on one server, a join, then one
    more: (losses, parameters or the error, retried keys, failed keys)."""
    from byteps_tpu_torch.models import mlp
    from byteps_tpu_torch.training import make_ps_train_step
    cfg, init, b = _mlp_setup()
    batch = {"x": torch.from_numpy(b["x"]),
             "y": torch.from_numpy(b["y"].astype(np.int64))}
    ports = [_free_port(), _free_port()]
    servers = [_serve(p) for p in ports]
    _codec_env(monkeypatch, tmp_path, ports)
    model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
    bps.init(device="cpu")
    try:
        step = make_ps_train_step(
            lambda bb: mlp.loss_fn(model.params(), bb, cfg),
            torch.optim.SGD(model.parameters(), lr=MLP_LR, momentum=MLP_MU),
            model.params(), compression=ONEBIT,
            device_compress=device_compress)

        def run():
            losses = [float(step(batch))]
            bps.add_server(f"127.0.0.1:{ports[1]}")
            try:
                losses.append(float(step(batch)))
            except RuntimeError as e:
                return losses, e
            return losses, None

        losses, err = bounded(run)
        rec = flight.get_recorder()
        out = (losses, err or {n: p.detach().numpy().copy()
                               for n, p in model.named_parameters()},
               _events(rec, "wire_retry"), _events(rec, "round_failed"))
        step.close()
    finally:
        bps.shutdown()
    for t in servers:
        t.join(10)
        assert not t.is_alive()
    return out


def _jax_through_join(monkeypatch, tmp_path, device_compress):
    """``_port_through_join`` with the JAX ``make_ps_train_step``."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core import flight as jflight
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import mlp as jmlp
    from byteps_tpu.parallel.mesh import make_mesh

    _, init, b = _mlp_setup()
    jcfg = jmlp.MLPConfig(in_dim=64, hidden=(48, 32), n_classes=10)
    params = jax.tree.map(jnp.asarray, init)
    tx = optax.sgd(MLP_LR, momentum=MLP_MU)
    opt = tx.init(params)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    ports = [_free_port(), _free_port()]
    servers = [_serve(p) for p in ports]
    _codec_env(monkeypatch, tmp_path, ports)
    GlobalState._instance = None
    jbps.init()
    try:
        step = j_make(lambda p, bb: jmlp.loss_fn(p, bb, jcfg), tx,
                      make_mesh(devices=jax.devices()[:1]),
                      compression=ONEBIT, device_compress=device_compress)

        def run():
            nonlocal params, opt
            with jax.default_matmul_precision("float32"):
                params, opt, loss = step(params, opt, batch)
                losses = [float(loss)]
                jbps.add_server(f"127.0.0.1:{ports[1]}")
                try:
                    params, opt, loss = step(params, opt, batch)
                except RuntimeError as e:
                    return losses, e
                losses.append(float(loss))
                return losses, None

        losses, err = bounded(run, timeout=120)
        rec = jflight.get_recorder()
        out = (losses, err or {k: np.asarray(v) for k, v in params.items()},
               _events(rec, "wire_retry"), _events(rec, "round_failed"))
    finally:
        jbps.shutdown()
        GlobalState._instance = None
    for t in servers:
        t.join(10)
        assert not t.is_alive()
    return out


@pytest.mark.parametrize("tier", ["host", "device"])
def test_moved_compressed_keys_behave_as_in_jax(jax_uses_port_lib,
                                                monkeypatch, tmp_path,
                                                tier):
    """The host-codec tier self-heals: the first push of a moved key
    meets a store with no codec, and its retry installs the codec; the
    same keys retry in both packages and the step agrees with JAX's at
    the dense tolerance. The device tier's moved keys are refused for
    good in both (their retries re-init a dense store and install no
    codec): ROADMAP.md §C."""
    dc = tier == "device"
    got = _port_through_join(monkeypatch, tmp_path, dc)
    want = _jax_through_join(monkeypatch, tmp_path, dc)
    assert got[2] == want[2] and got[2], (got[2], want[2])
    if dc:
        assert isinstance(got[1], RuntimeError)
        assert isinstance(want[1], RuntimeError)
        assert got[3] == want[3] and got[3]
        return
    assert not got[3] and not want[3]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for n, w in want[1].items():
        np.testing.assert_allclose(got[1][n], w, rtol=0, atol=1e-6,
                                   err_msg=n)


# --------------------------------------------------------------------- #
# a mixed JAX + port fleet joins one server
# --------------------------------------------------------------------- #

def test_mixed_fleet_joins_alike(jax_uses_port_lib, monkeypatch, tmp_path):
    """JAX worker 0 here and port worker 1 in a spawned process push a
    round of each tensor to server 0 of a fleet of two workers, each
    joins server 1 at the round boundary (``add_server``), then a second
    round: both compute the same routing table, and both rounds give
    both workers the mean of the two, bit for bit."""
    import jax

    import byteps_tpu as jbps
    import _torch_port_worker as W
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.parallel.mesh import make_mesh

    ports = [_free_port(), _free_port()]
    servers = [_serve(p, num_workers=2) for p in ports]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    out = str(tmp_path / "port.npz")
    proc = mp.get_context("spawn").Process(target=W.run_elastic_mixed,
                                           args=(ports, out))
    proc.start()
    _fleet_env(monkeypatch, ports[:1], num_workers=2)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    GlobalState._instance = None
    jbps.init(mesh=make_mesh(devices=jax.devices()[:1]))
    got = {}
    try:
        def run():
            xs = W.elastic_mixed_inputs(0)
            for r in range(2):
                if r == 1:
                    got["join"] = jbps.add_server(addrs[1])
                    got["table"] = W.elastic_table(
                        jbps.get_state().registry)
                for (name, _), x in zip(W.ELASTIC_MIXED, xs):
                    got[f"{r}/{name}"] = np.asarray(jbps.synchronize(
                        jbps.push_pull_async(x, name)))

        bounded(run, timeout=90)
    finally:
        jbps.shutdown()
        GlobalState._instance = None
        proc.join(60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    assert proc.exitcode == 0
    port = dict(np.load(out))
    assert int(port["join"]) == got["join"] == 1
    assert list(port["table"]) == got["table"]
    assert any(t.endswith("/1") or "/1," in t for t in got["table"])
    want = [(a + b) / np.float32(2) for a, b in zip(
        W.elastic_mixed_inputs(0), W.elastic_mixed_inputs(1))]
    for r in range(2):
        for (name, _), w in zip(W.ELASTIC_MIXED, want):
            np.testing.assert_array_equal(port[f"{r}/{name}"], w)
            np.testing.assert_array_equal(got[f"{r}/{name}"], w)
    for t in servers:
        t.join(10)
        assert not t.is_alive()


def test_device_tier_on_a_resumed_client_is_a_fresh_ones(ps_lib,
                                                         monkeypatch):
    """The device tier keys its codecs to the client, as the JAX step
    does: after a suspend/resume it installs them anew on the resumed
    client (error feedback restarting), and its next steps equal, bit
    for bit, those after a shutdown and a new ``init``."""
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import make_ps_train_step
    cfg, batch = _tiny()
    monkeypatch.setenv("BYTEPS_MIN_COMPRESS_BYTES", "4096")

    def run(resume: bool):
        model = tl.Llama(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        ports = [_free_port(), _free_port()]
        servers = [_serve(ports[0])]
        _fleet_env(monkeypatch, ports[:1])
        bps.init(device="cpu")
        try:
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg),
                torch.optim.Adam(model.parameters(), lr=1e-3),
                model.params(), compression=ONEBIT)
            losses = bounded(lambda: [float(step(batch)) for _ in range(2)])
            first = step.device_compressor()
            if resume:
                bps.suspend()
                bps.resume(1, 1)
            else:
                bps.shutdown()
                servers.append(_serve(ports[1]))
                _fleet_env(monkeypatch, ports[1:])
                bps.init(device="cpu")
            losses += bounded(lambda: [float(step(batch))
                                       for _ in range(2)])
            assert step.device_compressor() is not first
        finally:
            bps.shutdown()
        for t in servers:
            t.join(10)
            assert not t.is_alive()
        return losses, [p.detach().clone() for p in model.parameters()]

    a, b = run(True), run(False)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
