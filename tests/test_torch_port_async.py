"""Asynchronous PS training in the port (BYTEPS_ENABLE_ASYNC), against
the JAX package.

- the protocol with two port clients, the counterpart of
  tests/test_async_ps.py::test_async_protocol_two_workers, exact: both
  seed the weights (the init barrier), and every pull holds every delta
  folded so far, with no barrier of the workers;
- the knobs: ``enable_async`` and ``retired_servers`` read as the JAX
  ``Config.from_env`` reads them;
- ``make_async_ps_train_step`` against the JAX one, each on its own
  async server, Llama ``tiny()`` in f32 with SGD + momentum for 3 steps:
  losses within 1e-5, parameters within 1e-6 (the dense PS tolerance of
  tests/test_torch_port_dense_ps.py);
- the port's async step is bit for bit a local replay that folds each
  step's delta into f32 weights as the server does; a resumed client is
  seeded again, and so is a key that a join or a drain moves onto a
  server that holds no weights for it;
- without a PS the async step is the local step, bit for bit.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.core.types import DataType
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.server import run_server
from byteps_tpu_torch.server.client import PSClient
from byteps_tpu_torch.training import make_async_ps_train_step
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


V, S, STEPS = 64, 32, 3
LR, MU = 0.05, 0.9


def _async_server(port, num_workers=1):
    t = threading.Thread(target=run_server, args=(port, Config(
        num_workers=num_workers, num_servers=1, enable_async=True)),
        daemon=True)
    t.start()
    return t


def test_async_protocol_two_clients(ps_lib):
    port = _free_port()
    server = _async_server(port, num_workers=2)
    reg = TensorRegistry(Config(num_workers=2, num_servers=1))
    ctx = reg.init_tensor("w", 64 * 4, DataType.FLOAT32)
    w0 = np.arange(64, dtype=np.float32)
    c0 = PSClient([f"127.0.0.1:{port}"], 0)
    c1 = PSClient([f"127.0.0.1:{port}"], 1)
    try:
        def body():
            # the init barrier: both seed before either goes on
            t = threading.Thread(target=c1.init_weights,
                                 args=(ctx, w0.copy()))
            t.start()
            c0.init_weights(ctx, w0.copy())
            t.join(timeout=10)
            assert not t.is_alive()
            d0 = np.full(64, 0.5, np.float32)
            np.testing.assert_array_equal(
                c0.push_delta_pull_weights([ctx], [d0])[0], w0 + 0.5)
            d1 = np.full(64, 0.25, np.float32)
            np.testing.assert_array_equal(
                c1.push_delta_pull_weights([ctx], [d1])[0], w0 + 0.75)
            # worker 0 again at once: an async round never parks
            np.testing.assert_array_equal(
                c0.push_delta_pull_weights([ctx], [d0])[0], w0 + 1.25)

        bounded(body, timeout=30)
    finally:
        c0.close(shutdown_servers=True)
        c1.close(shutdown_servers=True)
    server.join(timeout=10)
    assert not server.is_alive()


@pytest.mark.parametrize("env", [
    {}, {"BYTEPS_ENABLE_ASYNC": "1", "BYTEPS_RETIRED_SERVERS": "0,3"},
    {"BYTEPS_ENABLE_ASYNC": "0", "BYTEPS_RETIRED_SERVERS": " 2 ,"}],
    ids=["unset", "on", "off"])
def test_async_and_elastic_knobs_read_as_jax(monkeypatch, env):
    import byteps_tpu.config as jconfig
    for k in ("BYTEPS_ENABLE_ASYNC", "BYTEPS_RETIRED_SERVERS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    c, j = Config.from_env(), jconfig.Config.from_env()
    assert (c.enable_async, c.retired_servers) == (
        j.enable_async, j.retired_servers)


def _cfg():
    return dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                               dtype=torch.float32)


def _tokens():
    return np.random.RandomState(5).randint(0, V, (2, S + 1)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_async_run(monkeypatch):
    """STEPS JAX async steps of tiny() from its seeded init on an async
    server: (initial weights, losses, final parameters)."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_async_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=jnp.float32)
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    init = jax.tree.map(np.asarray, params)
    tx = optax.sgd(LR, momentum=MU)
    opt = tx.init(params)
    tokens = jnp.asarray(_tokens())
    port = _free_port()
    server = _async_server(port)
    _ps_env(monkeypatch, port)
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    GlobalState._instance = None
    jbps.init()
    try:
        step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx,
                      make_mesh(devices=jax.devices()[:1]))

        def run():
            nonlocal params, opt
            out = []
            with jax.default_matmul_precision("float32"):
                for _ in range(STEPS):
                    params, opt, loss = step(params, opt,
                                             {"tokens": tokens})
                    out.append(float(loss))
            return out

        losses = bounded(run, timeout=120)
    finally:
        jbps.shutdown()
        GlobalState._instance = None
    server.join(10)
    assert not server.is_alive()
    return init, losses, _flat(jax.tree.map(np.asarray, params))


def _port_async_run(monkeypatch, init, optimizer, servers=True,
                    resume_after=None, join_drain=False):
    """STEPS port async steps of tiny() from ``init``: (losses, model,
    the step's counters, the keys each fleet event moved).
    ``resume_after``: suspend after that step and resume onto a fresh
    async server. ``join_drain``: a second async server joins after step
    0, and server 0 is drained after step 1."""
    cfg = _cfg()
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(init, device="cpu"))
    batch = {"tokens": torch.from_numpy(_tokens())}
    ports = [_free_port(), _free_port(), _free_port()]
    threads, moved = [], {}
    if servers:
        threads.append(_async_server(ports[0]))
        _ps_env(monkeypatch, ports[0])
    else:
        _ps_env(monkeypatch, ports[0])
        monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    bps.init(device="cpu")
    try:
        step = make_async_ps_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg),
            optimizer(model.parameters()), model.params())

        def run():
            losses = []
            for i in range(STEPS):
                losses.append(float(step(batch)))
                if join_drain and i == 0:
                    threads.append(_async_server(ports[2]))
                    reg = bps.get_state().registry
                    before = reg.server_loads()[0]
                    assert bps.add_server(f"127.0.0.1:{ports[2]}") == 1
                    moved["join"] = before - reg.server_loads()[0]
                if join_drain and i == 1:
                    moved["drain"] = len(bps.drain_server(0))
                if i == resume_after:
                    bps.suspend()
                    threads.append(_async_server(ports[1]))
                    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(ports[1]))
                    bps.resume(1, 1)
            return losses

        losses = bounded(run)
        counters = dict(step.counters)
    finally:
        bps.shutdown()
    if resume_after is not None:
        # the suspended client's server waits for its SHUTDOWN
        PSClient([f"127.0.0.1:{ports[0]}"], 0).close()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return losses, model, counters, moved


def _sgd(ps):
    return torch.optim.SGD(ps, lr=LR, momentum=MU)


def test_async_step_matches_jax(jax_uses_port_lib, monkeypatch):
    init, j_losses, j_params = _jax_async_run(monkeypatch)
    losses, model, counters, _ = _port_async_run(monkeypatch, init, _sgd)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for n, p in model.named_parameters():
        n = n.replace(".", "/")
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    nbytes = sum(p.numel() * 4 for p in model.parameters())
    assert counters == {"bytes_pushed": nbytes, "bytes_pulled": nbytes}


def _init():
    p = tl.init_params(_cfg(), torch.Generator().manual_seed(4), "cpu")
    return {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy()) for k, v in p.items()}


def _adam(ps):
    return torch.optim.Adam(ps, lr=1e-3)


def _replay(init, fold: bool):
    """STEPS local Adam steps of tiny(); ``fold``: the weights become the
    server's, the old weights plus the step's delta in f32."""
    cfg = _cfg()
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(init, device="cpu"))
    opt = _adam(model.parameters())
    batch = {"tokens": torch.from_numpy(_tokens())}
    losses = []
    for _ in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = tl.loss_fn(model.params(), batch, cfg)
        loss.backward()
        losses.append(float(loss.detach()))
        old = [p.detach().clone() for p in model.parameters()]
        opt.step()
        if fold:
            with torch.no_grad():
                for p, o in zip(model.parameters(), old):
                    p.copy_(o + (p - o))
    return losses, model


@pytest.mark.parametrize("resume_after,join_drain",
                         [(None, False), (0, False), (None, True)],
                         ids=["steady", "resume", "join_drain"])
def test_async_step_is_the_replay_of_its_deltas(ps_lib, monkeypatch,
                                                resume_after, join_drain):
    """One worker: the server's weights are the seed plus every delta, so
    the run is a local replay that folds each delta in f32. A resumed
    client (a fresh server) is seeded again from the worker's weights,
    and so is each key that a join or a drain moves."""
    init = _init()
    losses, model, _, moved = _port_async_run(
        monkeypatch, init, _adam, resume_after=resume_after,
        join_drain=join_drain)
    if join_drain:
        assert moved["join"] > 0 and moved["drain"] > 0, moved
    want_losses, want = _replay(init, fold=True)
    assert losses == want_losses
    for (n, p), w in zip(model.named_parameters(), want.parameters()):
        assert torch.equal(p, w), n


def test_async_step_without_a_ps_is_the_local_step(monkeypatch):
    init = _init()
    losses, model, counters, _ = _port_async_run(monkeypatch, init, _adam,
                                                 servers=False)
    want_losses, want = _replay(init, fold=False)
    assert losses == want_losses
    for (n, p), w in zip(model.named_parameters(), want.parameters()):
        assert torch.equal(p, w), n
    assert counters == {"bytes_pushed": 0, "bytes_pulled": 0}
