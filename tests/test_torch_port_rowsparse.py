"""The port's row-sparse wire against the JAX package.

- the row-aligned partition table of ``init_tensor(..., align_bytes=)``
  and the bytes of ``build_rowsparse_payload`` equal the JAX registry's
  and client's; a crash migration keeps a row-sparse key's partitions;
- ``push_pull_rowsparse`` and ``push_pull_rowsparse_async`` through one
  loopback server, fused and two-op, return the dense gradient; a mixed
  fleet of a JAX worker and a port worker gets one aggregate;
- ``make_ps_train_step(rowsparse_params=("embed",))`` on Llama
  ``tiny()`` in fp32: the host tier equals the JAX step (losses to 1e-5,
  parameters to 1e-6, the same declared keys) and the port's dense step
  bit for bit; the device tier (dithering + EF) sends the embedding
  row-sparse and its update equals a local step on the dense gradient,
  and two of its steps match the JAX device tier's.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu.config import Config as JConfig
from byteps_tpu.core import types as jtypes
from byteps_tpu.core.registry import TensorRegistry as JRegistry
from byteps_tpu.server import client as jclient
from byteps_tpu_torch.config import Config
from byteps_tpu_torch.core import types as ttypes
from byteps_tpu_torch.core.registry import TensorRegistry
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.server import client as tclient
from byteps_tpu_torch.training import make_ps_train_step
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

V, S, STEPS = 256, 32, 2
PART = "8192"       # 32 embedding rows of 256 bytes a partition


def _sparse_rows(rows, width, seed, keep=0.2):
    rs = np.random.RandomState(seed)
    x = rs.randn(rows, width).astype(np.float32)
    x[rs.rand(rows) > keep] = 0
    return x


@pytest.mark.parametrize("rows,width,part", [(256, 64, 8192),
                                             (1000, 3, 4096),
                                             (37, 100, 4096)])
def test_partitions_and_payloads_match_jax(rows, width, part):
    kw = dict(num_servers=3, partition_bytes=part, key_hash_fn="mixed")
    jreg, treg = JRegistry(JConfig(**kw)), TensorRegistry(Config(**kw))
    x = _sparse_rows(rows, width, seed=rows)
    for name in ("dense/a", "emb/rows", "dense/b"):
        align = width * 4 if name.startswith("emb") else None
        jc = jreg.init_tensor(name, x.nbytes, jtypes.DataType.FLOAT32,
                              align_bytes=align)
        tc = treg.init_tensor(name, x.nbytes, ttypes.DataType.FLOAT32,
                              align_bytes=align)
        assert [dataclasses.astuple(p) for p in tc.partitions] == \
            [dataclasses.astuple(p) for p in jc.partitions], name
    assert treg.server_loads() == jreg.server_loads()
    nz = tclient.nonzero_rows(x)
    assert len(tc.partitions) > 1
    for jp, tp in zip(jreg.get("emb/rows").partitions,
                      treg.contexts_in_order()[1].partitions):
        want = jclient.build_rowsparse_payload(jp, nz, x)
        got = tclient.build_rowsparse_payload(tp, nz, x)
        assert got.dtype == np.uint8 and bytes(got) == bytes(want)
    # a partition off the row boundaries is refused by both
    bad = jtypes.Partition(key=1, index=0, offset=4, length=width * 4)
    for build in (jclient.build_rowsparse_payload,
                  tclient.build_rowsparse_payload):
        with pytest.raises(ValueError, match="row-aligned"):
            build(bad, nz, x)


def test_migration_keeps_a_rowsparse_keys_partitions():
    treg = TensorRegistry(Config(num_servers=2, partition_bytes=4096))
    ctx = treg.init_tensor("emb", 40 * 300 * 4, ttypes.DataType.FLOAT32,
                           align_bytes=300 * 4)
    before = [(p.offset, p.length) for p in ctx.partitions]
    assert all(o % 1200 == 0 and n % 1200 == 0 for o, n in before)
    assert treg.migrate_server(1)
    assert [(p.offset, p.length) for p in ctx.partitions] == before
    assert {p.server for p in ctx.partitions} == {0}
    # an unchanged re-init keeps the table; a changed alignment rebuilds it
    assert treg.init_tensor("emb", ctx.nbytes, align_bytes=1200) is ctx
    assert [(p.offset, p.length) for p in ctx.partitions] == before
    treg.init_tensor("emb", ctx.nbytes, align_bytes=None)
    assert ctx.align_bytes is None and ctx.partitions[0].length == 4096


@pytest.mark.parametrize("fused", ["1", "0"])
def test_rowsparse_round_returns_the_dense_gradient(ps_lib, monkeypatch,
                                                    fused):
    x = _sparse_rows(300, 50, seed=3)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "4096")
        monkeypatch.setenv("BYTEPS_FUSED_PUSHPULL", fused)
        bps.init(device="cpu")
        try:
            st = bps.get_state()
            pushed0 = st.scheduler.counters()["bytes_pushed"]

            def run():
                a = bps.push_pull_rowsparse(x, "emb")
                b = bps.push_pull_rowsparse(torch.from_numpy(2 * x), "emb")
                h = bps.push_pull_rowsparse_async(3 * x, "emb")
                c = bps.synchronize(h)
                assert bps.poll(h)
                return a, b, c

            a, b, c = bounded(run)
            ctx = st.registry.declare("emb")
            nnz = int(np.any(x != 0, axis=1).sum())
            want_bytes = 8 * len(ctx.partitions) + nnz * (4 + 50 * 4)
            assert st.scheduler.counters()["bytes_pushed"] - pushed0 == \
                3 * want_bytes
            assert len(ctx.partitions) == 15 and \
                all(p.length % 200 == 0 for p in ctx.partitions)
            with pytest.raises(ValueError, match="rows, width"):
                bps.push_pull_rowsparse(x.reshape(-1), "flat")
        finally:
            bps.shutdown()
    np.testing.assert_array_equal(a, x)
    np.testing.assert_array_equal(b, 2 * x)
    np.testing.assert_array_equal(c, 3 * x)


def test_mixed_fleet_rowsparse_round(ps_lib, monkeypatch, jax_uses_port_lib):
    """Worker 0 is the JAX package, worker 1 the port: one row-sparse key
    of several partitions, each worker its own rows; both get the mean."""
    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState

    xs = [_sparse_rows(200, 40, seed=s) for s in (5, 6)]
    with ps_server(num_workers=2) as port:
        _ps_env(monkeypatch, port, num_workers=2)
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "4096")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        GlobalState._instance = None
        jbps.init()
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        bps.init(device="cpu")
        try:
            def both():
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    fs = [pool.submit(jbps.push_pull_rowsparse, xs[0], "e"),
                          pool.submit(bps.push_pull_rowsparse, xs[1], "e")]
                    return [f.result() for f in fs]

            j_out, t_out = bounded(both)
        finally:
            bps.shutdown()
            jbps.shutdown()
            GlobalState._instance = None
    np.testing.assert_array_equal(j_out, t_out)
    np.testing.assert_array_equal(t_out, (xs[0] + xs[1]) / np.float32(2))


# --------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------- #

LR, MU = 0.05, 0.9
KW = {"compressor": "dithering", "ef": "vanilla"}
# the leaves of whole 8192-byte partitions compress (the matrices), the
# norms do not
MIN_BYTES = 8192


def _cfg():
    return dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                               dtype=torch.float32)


def _tokens():
    return np.random.RandomState(2).randint(0, V, (2, S + 1)).astype(
        np.int32)


def _env(mp, port):
    _ps_env(mp, port)
    mp.setenv("BYTEPS_FUSION_BYTES", "16384")
    mp.setenv("BYTEPS_PARTITION_BYTES", PART)


def _jax_run(mp, adam=False, **step_kw):
    """Two JAX steps with the embedding row-sparse, on the host tier (SGD
    with momentum) or, with ``adam`` and a ``compression``, on the device
    tier: the initial weights, losses, final parameters and declared
    names."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=jnp.float32)
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg)
    init = jax.tree.map(np.asarray, params)
    tx = optax.adam(1e-3) if adam else optax.sgd(LR, momentum=MU)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:1])
    tokens = _tokens()
    losses = []
    mp.setenv("BYTEPS_LEDGER", "0")
    with ps_server() as port:
        _env(mp, port)
        GlobalState._instance = None
        jbps.init()
        try:
            step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh,
                          rowsparse_params=("embed",), **step_kw)

            def run():
                nonlocal params, opt
                with jax.default_matmul_precision("float32"):
                    for _ in range(STEPS):
                        params, opt, loss = step(params, opt,
                                                 {"tokens": tokens})
                        losses.append(float(loss))

            bounded(run, timeout=120)
            names = set(jbps.get_state().registry._contexts)
        finally:
            jbps.shutdown()
            GlobalState._instance = None
    flat = {}
    for k, v in jax.tree.map(np.asarray, params).items():
        if isinstance(v, dict):
            flat.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    return init, losses, flat, names


def _jax_with_port_lib(ps_lib, **kw):
    import byteps_tpu.native.build as jbuild
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jclient):
            mp.setattr(mod, "build", lambda *a, **k: ps_lib)
        mp.setenv("BYTEPS_NATIVE_CODEC", "0")
        return _jax_run(mp, **kw)


@pytest.fixture(scope="module")
def jax_rowsparse(ps_lib):
    return _jax_with_port_lib(ps_lib)


@pytest.fixture(scope="module")
def jax_rowsparse_device(ps_lib):
    return _jax_with_port_lib(ps_lib, adam=True, compression=KW,
                              min_compress_bytes=MIN_BYTES)


def _port_run(monkeypatch, init, optimizer, steps=STEPS, **kw):
    cfg = _cfg()
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(init, device="cpu"))
    tokens = torch.from_numpy(_tokens())
    with ps_server() as port:
        _env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg),
                optimizer(model.parameters()), model.params(), **kw)
            losses = bounded(lambda: [float(step({"tokens": tokens}))
                                      for _ in range(steps)])
            st = bps.get_state()
            names = set(st.registry._contexts)
            parts = [(p.offset, p.length) for p in
                     st.registry.declare("grad/embed").partitions]
            counters = dict(getattr(step, "counters", {}))
            if hasattr(step, "device_compressor"):
                counters["compressed"] = {
                    n[len("grad/"):] for n, p in
                    step.device_compressor()._plans.items() if any(p.codecs)}
            step.close()
        finally:
            bps.shutdown()
    params = {n.replace(".", "/"): p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    return losses, params, names, parts, counters


def _sgd(ps):
    return torch.optim.SGD(ps, lr=LR, momentum=MU)


def test_host_tier_rowsparse_matches_jax_and_the_dense_step(
        jax_rowsparse, monkeypatch):
    init, j_losses, j_params, j_names = jax_rowsparse
    losses, params, names, parts, counters = _port_run(
        monkeypatch, init, _sgd, rowsparse_params=("embed",))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(p, j_params[n], rtol=0, atol=1e-6,
                                   err_msg=n)
    assert names == j_names
    assert len(parts) == 8 and all(n == 8192 for _, n in parts)
    # the embedding rode the wire row-sparse: the rows of the batch only
    rows = len(np.unique(_tokens()[:, :-1]))
    assert counters["rowsparse_bytes"] == 8 * 8 + rows * (4 + 64 * 4)
    assert counters["leaves_post_backward"] >= 1
    d_losses, d_params, d_names, _, _ = _port_run(monkeypatch, init, _sgd)
    assert losses == d_losses
    for n, p in params.items():
        np.testing.assert_array_equal(p, d_params[n], err_msg=n)
    # the row-sparse leaf closes the norms' bucket before it (as in JAX)
    assert "grad/final_norm" in names - d_names


def test_device_tier_sends_the_embedding_rowsparse(monkeypatch):
    """Dithering + EF on the card for every leaf but the embedding, which
    travels row-sparse: its update is a local Adam step on its dense
    gradient, bit for bit."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(5)
    init = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in tl.init_params(cfg, gen, "cpu").items()}
    losses, params, names, _, counters = _port_run(
        monkeypatch, init, lambda ps: torch.optim.Adam(ps, lr=1e-3), steps=1,
        compression=KW, min_compress_bytes=MIN_BYTES,
        rowsparse_params=("embed",))
    assert "lm_head" in counters["compressed"]
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(init, device="cpu"))
    opt = torch.optim.Adam([model.embed], lr=1e-3)
    tl.loss_fn(model.params(), {"tokens": torch.from_numpy(_tokens())},
               cfg).backward()
    opt.step()
    np.testing.assert_array_equal(params["embed"],
                                  model.embed.detach().numpy())
    assert all(np.isfinite(p).all() for p in params.values())
    assert "grad/embed" in names and np.isfinite(losses).all()


def _adam(ps):
    return torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def test_device_tier_rowsparse_matches_jax(jax_rowsparse_device,
                                          monkeypatch):
    """The device tier with the embedding row-sparse, against the JAX
    step on the same weights and tokens, at the tolerances of
    ``test_torch_port_ps.py::test_two_ps_steps_match_jax``: losses to
    1e-5; the leaves that travel uncompressed (the embedding among them)
    to 1e-6; in the dithered leaves at most 1e-3 of the elements may take
    the other stochastic level. Both declare the same keys."""
    init, j_losses, j_params, j_names = jax_rowsparse_device
    losses, params, names, parts, counters = _port_run(
        monkeypatch, init, _adam, compression=KW,
        min_compress_bytes=MIN_BYTES, rowsparse_params=("embed",))
    compressed = counters["compressed"]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert {"lm_head", "blocks/w_gate"} <= compressed
    assert "embed" not in compressed
    flipped = total = 0
    for n, p in params.items():
        off = np.abs(p - j_params[n]) > 1e-6
        if n in compressed:
            flipped += int(off.sum())
            total += off.size
        else:
            np.testing.assert_allclose(p, j_params[n], rtol=0, atol=1e-6,
                                       err_msg=n)
    assert flipped <= 1e-3 * total, (flipped, total)
    assert names == j_names
    assert len(parts) == 8 and all(n == 8192 for _, n in parts)
