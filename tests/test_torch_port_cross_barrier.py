"""Cross-barrier bounded staleness in the port's host-tier PS step
(BYTEPS_CROSS_BARRIER, BYTEPS_STALENESS; ``HostTierStep``'s carry and
``step.flush()``), on an MLP and a loopback server.

- ``ScheduledQueue(window=w)`` admits up to ``w + 1`` rounds of a key
  without a codec stack, in submission order, and one of a host-codec
  key; the scheduler's ``xb_window`` is the staleness on the fused
  PUSHPULL with cross-barrier on, and 0 on the two-op path or with
  cross-barrier off;
- at staleness 0 the step is the synchronous step bit for bit: dense,
  with a fused bucket, under host onebit + EF, and with the per-leaf
  apply off (the arms of tests/test_barrier_window.py:397-417);
- the synchronous step matches the JAX ``make_ps_train_step`` at the
  dense tolerance (SGD + momentum);
- at staleness 1 under a slowed, throttled server, with the replies of
  the last two weights held past each step's drain
  (``_torch_port_ps_util.held_replies``, so that a loaded host cannot
  empty the carry schedule), the step carries
  (``carried_leaves > 0``), every loss is finite, and after ``flush()``
  the parameters equal, bit for bit, a plain local replay of the carry
  schedule the step recorded: each carried leaf's update applied one
  step late; ``flush()`` twice is ``flush()`` once, and ``close()``
  without ``flush()`` lands the carry too; so does a run with a server
  joined after a step that carried and a drain two steps later;
- a dp group of two gloo processes: the root decides the carry, both
  ranks carry the same leaves and end bit for bit on the replay of the
  schedule on the ranks' mean gradient.
"""


import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.core.scheduler import PipelineScheduler, ScheduledQueue
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.models import mlp
from byteps_tpu_torch.training import make_ps_train_step
from byteps_tpu_torch.training.optim import make_leaf_apply
from _torch_port_ps_util import (
    _ps_env, bounded, held_replies, ps_server, replies_in_before_drain,
)
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

# the carry-eligible leaves whose replies the carry tests hold past the
# drain: the last two of the back half
HELD = ("grad/w2", "grad/w3")

XB_VARS = ("BYTEPS_CROSS_BARRIER", "BYTEPS_STALENESS", "BYTEPS_FUSION_BYTES",
           "BYTEPS_CHAOS_SLOW_SERVER", "BYTEPS_SERVER_THROTTLE_MBPS",
           "BYTEPS_FUSED_PUSHPULL", "BYTEPS_STREAM_EXPORT")


def _setup(hidden=(48, 32)):
    cfg = mlp.MLPConfig(in_dim=64, hidden=hidden, n_classes=10)
    init = {k: v.numpy() for k, v in mlp.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").items()}
    rs = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rs.rand(32, 64).astype(np.float32)),
             "y": torch.from_numpy(rs.randint(0, 10, 32).astype(np.int64))}
    return cfg, init, batch


def _adam(ps):
    return torch.optim.Adam(ps, lr=1e-2)


def _run(monkeypatch, cfg, init, batch, env, steps=4, flush=False,
         optimizer=_adam, hold=(), **kw):
    """``steps`` PS steps of the MLP from ``init`` against a loopback
    server started under ``env``: the parameters (after ``step.close()``,
    which lands what is still carried), the losses, each step's counters
    and the scheduler's window. ``hold``: tensor names whose replies
    complete only after each step has returned (``held_replies``)."""
    for k in XB_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            window = bps.get_state().scheduler.xb_window
            step = make_ps_train_step(
                lambda b: mlp.loss_fn(model.params(), b, cfg),
                optimizer(model.parameters()), model.params(), **kw)
            per_step = []

            def run():
                losses = []
                with held_replies(hold) as release:
                    for _ in range(steps):
                        losses.append(float(step(batch)))
                        per_step.append(dict(step.counters))
                        release()
                if flush:
                    step.flush()
                return losses

            losses = bounded(run)
            out = {n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()}
            if flush:
                step.flush()
                for n, p in model.named_parameters():
                    np.testing.assert_array_equal(p.detach().numpy(), out[n],
                                                  err_msg=n)
            bounded(step.close)
            out = {n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()}
        finally:
            bps.shutdown()
    return out, losses, per_step, window


class _Task:
    def __init__(self, key, stack=None):
        self.key, self.stack, self.priority, self.nbytes = key, stack, 0, 4


def test_queue_window_admits_successive_rounds_of_a_plain_key():
    q = ScheduledQueue(window=1)
    rounds = [_Task(5) for _ in range(3)]
    coded = [_Task(6, stack=object()) for _ in range(2)]
    for t in rounds + coded:
        q.add_task(t)
    got = [q.get_task() for _ in range(3)]
    # two rounds of key 5 in flight at once, in submission order, and one
    # of the host-codec key 6
    assert got == [rounds[0], rounds[1], coded[0]]
    q.report_finish(rounds[0])
    assert q.get_task() is rounds[2]
    q.report_finish(coded[0])
    assert q.get_task() is coded[1]
    q.stop()
    strict = ScheduledQueue()
    for t in rounds:
        strict.add_task(t)
    assert strict.get_task() is rounds[0]
    assert strict._pop_admissible_locked() is None


class _FusedClient:
    supports_fused = True


@pytest.mark.parametrize("env,window", [
    ({"BYTEPS_CROSS_BARRIER": "1"}, 1),
    ({"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "3"}, 3),
    ({"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "20"}, 8),
    ({"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "0"}, 0),
    ({"BYTEPS_STALENESS": "2"}, 0),
    ({"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_FUSED_PUSHPULL": "0"}, 0),
], ids=["default", "3", "clamped", "0", "off", "two-op"])
def test_scheduler_window(env, window, monkeypatch):
    import byteps_tpu.config as jconfig
    for k in XB_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    jcfg = jconfig.Config.from_env()
    assert (cfg.cross_barrier, cfg.staleness) == (jcfg.cross_barrier,
                                                  jcfg.staleness)
    sched = PipelineScheduler(_FusedClient(), num_threads=1, config=cfg)
    try:
        assert sched.xb_window == window
    finally:
        sched.stop()


STALENESS0_ARMS = [
    ("0", {}),
    ("4096", {}),
    ("0", dict(compression={"compressor": "onebit", "ef": "vanilla"},
               min_compress_bytes=0, device_compress=False)),
    ("0", dict(sharded_apply=False)),
]


@pytest.mark.parametrize("fusion,kw", STALENESS0_ARMS,
                         ids=["dense", "fused-bucket", "onebit",
                              "fused-apply"])
def test_staleness0_is_the_synchronous_step(fusion, kw, monkeypatch):
    cfg, init, batch = _setup()
    base, b_losses, _, w0 = _run(monkeypatch, cfg, init, batch,
                                 {"BYTEPS_FUSION_BYTES": fusion}, **kw)
    xb, x_losses, per_step, w1 = _run(
        monkeypatch, cfg, init, batch,
        {"BYTEPS_FUSION_BYTES": fusion, "BYTEPS_CROSS_BARRIER": "1",
         "BYTEPS_STALENESS": "0"}, **kw)
    assert (w0, w1) == (0, 0)
    assert b_losses == x_losses
    assert all(c["carried_leaves"] == 0 for c in per_step)
    for n, a in base.items():
        np.testing.assert_array_equal(a, xb[n], err_msg=n)


LR, MU = 0.05, 0.9


def _sgd(ps):
    return torch.optim.SGD(ps, lr=LR, momentum=MU)


def test_synchronous_step_matches_jax(jax_uses_port_lib, monkeypatch):
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import mlp as jmlp
    from byteps_tpu.parallel.mesh import make_mesh

    cfg, init, batch = _setup()
    jcfg = jmlp.MLPConfig(in_dim=64, hidden=(48, 32), n_classes=10)
    params = jax.tree.map(jnp.asarray, init)
    tx = optax.sgd(LR, momentum=MU)
    opt = tx.init(params)
    jbatch = {"x": jnp.asarray(batch["x"].numpy()),
              "y": jnp.asarray(batch["y"].numpy().astype(np.int32))}
    env = {"BYTEPS_FUSION_BYTES": "4096", "BYTEPS_CROSS_BARRIER": "1",
           "BYTEPS_STALENESS": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        GlobalState._instance = None
        jbps.init()
        try:
            step = j_make(lambda p, b: jmlp.loss_fn(p, b, jcfg), tx,
                          make_mesh(devices=jax.devices()[:1]))

            def run():
                nonlocal params, opt
                with jax.default_matmul_precision("float32"):
                    out = []
                    for _ in range(4):
                        params, opt, loss = step(params, opt, jbatch)
                        out.append(float(loss))
                    return out

            j_losses = bounded(run, timeout=120)
        finally:
            jbps.shutdown()
            GlobalState._instance = None
    got, losses, _, _ = _run(monkeypatch, cfg, init, batch, env,
                             optimizer=_sgd)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for n, want in params.items():
        np.testing.assert_allclose(got[n], np.asarray(want), rtol=0,
                                   atol=1e-6, err_msg=n)


def _replay(cfg, init, batch, schedule):
    """Plain local Adam steps in which the leaves named in
    ``schedule[t]`` take step t's update one step late, after step
    t + 1's backward (and the last step's after the run)."""
    model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
    apply = make_leaf_apply(_adam(model.parameters()))
    params = dict(model.named_parameters())
    late = {}
    for carried in schedule:
        model.zero_grad(set_to_none=True)
        mlp.loss_fn(model.params(), batch, cfg).backward()
        grads = {n: p.grad.clone() for n, p in params.items()}
        for n, g in late.items():
            params[n].grad = g
            apply.step(params[n])
        late = {}
        for n, p in params.items():
            if "grad/" + n in carried:
                late[n] = grads[n]
            else:
                p.grad = grads[n]
                apply.step(p)
    for n, g in late.items():
        params[n].grad = g
        apply.step(params[n])
    return {n: p.detach().numpy() for n, p in params.items()}


def test_staleness1_carries_and_equals_the_replay(monkeypatch):
    cfg, init, batch = _setup(hidden=(256, 256, 256))
    # a slowed server, and the keys submitted after the backward in
    # flatten order (the biases, then the weights, the carry-eligible
    # back half): the weights' replies are still out when the biases
    # have landed. (Streamed, this MLP's gradients leave in the order
    # the backward makes them, biases and weights interleaved, and every
    # reply is in by the time the last bias lands.)
    env = {"BYTEPS_FUSION_BYTES": "256", "BYTEPS_CROSS_BARRIER": "1",
           "BYTEPS_STALENESS": "1", "BYTEPS_CHAOS_SLOW_SERVER": "10",
           "BYTEPS_SERVER_THROTTLE_MBPS": "100",
           "BYTEPS_STREAM_EXPORT": "0"}
    got, losses, per_step, window = _run(monkeypatch, cfg, init, batch, env,
                                         steps=8, flush=True, hold=HELD)
    assert window == 1
    assert sum(c["carried_leaves"] for c in per_step) > 0, per_step
    assert np.isfinite(losses).all()
    for prev, c in zip(per_step, per_step[1:]):
        assert c["carry_drained"] == prev["carried_leaves"]
        assert c["carry_lag"] == (1 if prev["carried_leaves"] else None)
    carried = {n for c in per_step for n in c["carried"]}
    assert carried <= {"grad/w0", "grad/w1", "grad/w2", "grad/w3"}
    assert sum(c["carry_drained"] for c in per_step) <= sum(
        c["carried_leaves"] for c in per_step)
    want = _replay(cfg, init, batch, [c["carried"] for c in per_step])
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)


def test_close_lands_the_carry(monkeypatch):
    """Without ``flush()``, ``close()`` lands the last step's carried
    rounds: the parameters equal the replay of the recorded schedule."""
    cfg, init, batch = _setup(hidden=(256, 256, 256))
    env = {"BYTEPS_FUSION_BYTES": "256", "BYTEPS_CROSS_BARRIER": "1",
           "BYTEPS_STALENESS": "1", "BYTEPS_CHAOS_SLOW_SERVER": "10",
           "BYTEPS_SERVER_THROTTLE_MBPS": "100",
           "BYTEPS_STREAM_EXPORT": "0"}
    got, _, per_step, _ = _run(monkeypatch, cfg, init, batch, env, steps=8,
                               hold=HELD)
    assert sum(c["carried_leaves"] for c in per_step) > 0, per_step
    want = _replay(cfg, init, batch, [c["carried"] for c in per_step])
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)


def test_flush_is_idempotent_and_a_no_op_without_a_carry(monkeypatch):
    """``_run`` flushes twice (and holds the second flush to the first);
    here at staleness 1 on the streamed export with every reply in before
    the drain (``replies_in_before_drain``: a loaded host's late reply
    would be carried), so that nothing is carried, and with cross-barrier
    off."""
    cfg, init, batch = _setup()
    for env in ({"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_FUSION_BYTES": "256"},
                {}):
        with replies_in_before_drain():
            _, losses, per_step, _ = _run(monkeypatch, cfg, init, batch,
                                          env, steps=2, flush=True)
        assert np.isfinite(losses).all()
        assert all(c["carry_drained"] in (0, None) for c in per_step)


def _dp_replay(schedule):
    """The dp group's run replayed in one process: each step's gradient
    the mean of the two ranks' (the group's all-reduce, then the division
    by 2), and the leaves named in ``schedule[t]`` updated one step
    late, as ``_replay`` does."""
    import _torch_port_worker as W
    cfg, init, _ = W.xb_dp_setup(0)
    batches = [W.xb_dp_setup(r)[2] for r in range(2)]
    model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
    apply = make_leaf_apply(_adam(model.parameters()))
    params = dict(model.named_parameters())
    late = {}
    for carried in schedule:
        per_rank = []
        for b in batches:
            model.zero_grad(set_to_none=True)
            mlp.loss_fn(model.params(), b, cfg).backward()
            per_rank.append({n: p.grad.clone() for n, p in params.items()})
        grads = {n: (per_rank[0][n] + per_rank[1][n]).div_(2)
                 for n in params}
        for n, g in late.items():
            params[n].grad = g
            apply.step(params[n])
        late = {}
        for n, p in params.items():
            if "grad/" + n in carried:
                late[n] = grads[n]
            else:
                p.grad = grads[n]
                apply.step(p)
    for n, g in late.items():
        params[n].grad = g
        apply.step(params[n])
    return {n: p.detach().numpy() for n, p in params.items()}


def test_dp_group_of_two_carries_alike_and_equals_the_replay(
        monkeypatch, tmp_path):
    """A dp group of two gloo processes at staleness 1 against a slowed,
    throttled server, the keys after the backward, the root's replies of
    the last two weights held past each step's drain: the root decides
    the carry, and both ranks carry the same leaves in every step, land them
    in the next (``flush()`` the last), and end bit for bit on the same
    parameters, those of a local replay of the carry schedule on the
    ranks' mean gradient."""
    import multiprocessing as mp

    import _torch_port_worker as W
    for k in XB_VARS:
        monkeypatch.delenv(k, raising=False)
    # the server reads these as it starts
    for k, v in {"BYTEPS_CROSS_BARRIER": "1", "BYTEPS_STALENESS": "1",
                 "BYTEPS_CHAOS_SLOW_SERVER": "10",
                 "BYTEPS_SERVER_THROTTLE_MBPS": "100"}.items():
        monkeypatch.setenv(k, v)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    ctx = mp.get_context("spawn")
    with ps_server() as port:
        procs = [ctx.Process(target=W.run_dp_carry, args=(
            r, 2, str(tmp_path / "store"), port, outs[r])) for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=120)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        assert [p.exitcode for p in procs] == [0, 0]
    a, b = (dict(np.load(o)) for o in outs)
    np.testing.assert_array_equal(a["carried"], b["carried"])
    schedule = [set(c.split(";")) - {""} for c in a["carried"]]
    assert sum(map(len, schedule)) > 0, schedule
    assert set().union(*schedule) <= {"grad/w0", "grad/w1", "grad/w2",
                                      "grad/w3"}
    assert bool(a["flushed_carry"]) and bool(b["flushed_carry"])
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert np.isfinite(a["losses"]).all()
    want = _dp_replay(schedule)
    for n, w in want.items():
        np.testing.assert_array_equal(a["p/" + n], b["p/" + n], err_msg=n)
        np.testing.assert_array_equal(a["p/" + n], w, err_msg=n)


def test_a_join_waits_for_the_carried_round_and_the_replay_holds(
        monkeypatch):
    # the join and the drain write the fleet into os.environ: restored
    # with monkeypatch's records of the same names
    for name in ("BYTEPS_RETIRED_SERVERS", "BYTEPS_SERVER_HOSTS",
                 "DMLC_NUM_SERVER"):
        monkeypatch.setenv(name, "")
    """At staleness 1, a server joined after a step that carried (the
    join's quiescence waits for the carried round to land on its old
    server; the next step lands it as usual) and a drain of server 0 two
    steps later: the run still equals the local replay of its carry
    schedule, bit for bit. The last two weights' replies are held past
    each step's drain, so that the step before the join carries whatever
    the host's load."""
    import threading

    from byteps_tpu_torch.core import elastic
    from byteps_tpu_torch.server import run_server
    from _torch_port_ps_util import _free_port
    cfg, init, batch = _setup(hidden=(256, 256, 256))
    for k in XB_VARS:
        monkeypatch.delenv(k, raising=False)
    env = {"BYTEPS_FUSION_BYTES": "256", "BYTEPS_CROSS_BARRIER": "1",
           "BYTEPS_STALENESS": "1", "BYTEPS_CHAOS_SLOW_SERVER": "10",
           "BYTEPS_SERVER_THROTTLE_MBPS": "100",
           "BYTEPS_STREAM_EXPORT": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ports = [_free_port(), _free_port()]
    servers = [threading.Thread(target=run_server, args=(
        p, Config(num_workers=1, num_servers=1)), daemon=True)
        for p in ports]
    for t in servers:
        t.start()
    _ps_env(monkeypatch, ports[0])
    monkeypatch.setenv("BYTEPS_SERVER_HOSTS", f"127.0.0.1:{ports[0]}")
    model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
    bps.init(device="cpu")
    try:
        step = make_ps_train_step(
            lambda b: mlp.loss_fn(model.params(), b, cfg),
            _adam(model.parameters()), model.params())
        per_step = []

        def run():
            with held_replies(HELD) as release:
                for i in range(6):
                    step(batch)
                    per_step.append(dict(step.counters))
                    release()
                    if i == 1:
                        elastic.join_server(bps.get_state(),
                                            f"127.0.0.1:{ports[1]}")
                    if i == 3:
                        bps.drain_server(0)
            step.flush()

        bounded(run)
        step.close()
        got = {n: p.detach().numpy().copy()
               for n, p in model.named_parameters()}
    finally:
        bps.shutdown()
    for t in servers:
        t.join(10)
        assert not t.is_alive()
    # the join came after a step that carried
    assert per_step[1]["carried_leaves"] > 0, per_step
    want = _replay(cfg, init, batch, [c["carried"] for c in per_step])
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)
