"""A mixed fleet's key numbering under the streamed export.

One ``ps.cc`` server and two PS workers: worker 0 is the JAX
``make_ps_train_step`` on a one-device mesh in this process, worker 1 the
port's ``make_ps_train_step`` in a spawned process. The model is Llama
``tiny(vocab_size=64, seq=32)`` in fp32 with SGD + momentum on the dense
host tier, ``BYTEPS_FUSION_BYTES=16384`` (the block matrices, ``embed``
and ``lm_head`` stream, the three norm leaves ride one fused bucket).

A PS key is ``declared_key << 16``: the two workers meet only if they
declare their keys in one order. Both tests hold the port's declared keys
to the JAX worker's, name for name, and its parameters after two steps to
the JAX worker's at the dense tolerance (both apply one aggregate):

- with the streamed export on (both packages' default) the port declares
  its streamed keys before the backward, in flatten order; it used to
  declare them as autograd produced them (``lm_head`` first), and the
  fleet stalled on key 0. Flatten order is the JAX step's program order:
  its taps are ``io_callback(..., ordered=False)`` custom calls that the
  optimized HLO holds as siblings in flatten order, all reading one
  tuple, with no dependency among them. XLA's CPU runtime may run such
  independent calls concurrently, so the order in which they fire, and
  in which the JAX step declares, is not guaranteed (at fusion 0 three
  runs gave three orders). This case therefore declares the JAX
  worker's streamed keys in its program order before its first step,
  and holds the port to that order;
- with ``BYTEPS_STREAM_EXPORT=0`` on both workers, the setting that a
  mixed fleet meets with for every model and threshold, each JAX
  worker's own declaration order included (README, the port's section).

A stalled round fails in bounded time: the port worker's client gives up
after ``BYTEPS_CLIENT_TIMEOUT_S`` (long enough for the JAX worker's first
compile under a loaded test run, whose key inits the port's wait on),
and the JAX worker's step is bounded.
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest

import _torch_port_worker as W
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import ps_lib  # noqa: F401

CLIENT_TIMEOUT_S = "45"


def _jax_worker0(monkeypatch, init, declare=()):
    """Two JAX ``make_ps_train_step`` steps on a one-device mesh (row 0 of
    ``dp_tokens``), the keys named in ``declare`` declared first, in that
    order: the parameters and {name: declared key}. The caller sets the
    PS environment."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=W.DP_V,
                                                  seq=W.DP_S),
                              dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, init)
    tx = optax.sgd(W.DP_LR, momentum=W.DP_MU)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:1])
    tokens = W.dp_tokens()[0:1]
    GlobalState._instance = None
    jbps.init()
    try:
        for name in declare:
            jbps.get_state().registry.declare(name)
        step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh)

        def run():
            nonlocal params, opt
            with jax.default_matmul_precision("float32"):
                for _ in range(W.DP_STEPS):
                    params, opt, _ = step(params, opt, {"tokens": tokens})

        bounded(run, timeout=90)
        keys = {n: c.declared_key for n, c in
                jbps.get_state().registry._contexts.items()}
    finally:
        jbps.shutdown()
        GlobalState._instance = None
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(k.key for k in path)] = np.asarray(leaf)
    return flat, keys


def _program_order(init):
    """The JAX step's keys of the leaves that stream (at least
    ``BYTEPS_FUSION_BYTES``), in its program order: flatten order."""
    import jax
    return ["grad/" + "/".join(k.key for k in path)
            for path, leaf in jax.tree_util.tree_flatten_with_path(init)[0]
            if leaf.nbytes >= int(W.DP_FUSION)]


@pytest.mark.parametrize("stream", ["1", "0"],
                         ids=["streamed", "stream-export-off"])
def test_mixed_fleet_declares_the_jax_workers_keys(stream, tmp_path, ps_lib,
                                                   monkeypatch):
    import jax

    import byteps_tpu.native.build as jbuild
    from byteps_tpu.models import llama as jl
    from byteps_tpu.server import client as jclient

    for mod in (jbuild, jclient):
        monkeypatch.setattr(mod, "build", lambda *a, **k: ps_lib)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    import jax.numpy as jnp
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=W.DP_V,
                                                  seq=W.DP_S),
                              dtype=jnp.float32)
    init = jax.tree.map(np.asarray, jax.jit(
        jl.init_params, static_argnums=1)(jax.random.PRNGKey(1), cfg))
    params_path = str(tmp_path / "params.npz")
    W.save_params(params_path, init)
    out = str(tmp_path / "worker1.npz")
    with ps_server(num_workers=2) as port:
        proc = mp.get_context("spawn").Process(
            target=W.run_mixed_stream,
            args=(port, params_path, out, stream, CLIENT_TIMEOUT_S))
        proc.start()
        try:
            _ps_env(monkeypatch, port, num_workers=2)
            monkeypatch.setenv("DMLC_WORKER_ID", "0")
            monkeypatch.setenv("BYTEPS_FUSION_BYTES", W.DP_FUSION)
            monkeypatch.setenv("BYTEPS_STREAM_EXPORT", stream)
            monkeypatch.setenv("BYTEPS_CLIENT_TIMEOUT_S", CLIENT_TIMEOUT_S)
            j_params, j_keys = _jax_worker0(
                monkeypatch, init, _program_order(init) if stream == "1"
                else ())
        finally:
            proc.join(timeout=90)
            if proc.is_alive():
                proc.kill()
                proc.join()
    assert proc.exitcode == 0, proc.exitcode
    got = dict(np.load(out))
    assert sorted(got["keys"].tolist()) == sorted(
        f"{n}={k}" for n, k in j_keys.items())
    assert int(got["streamed"]) == (9 if stream == "1" else 0)
    if stream == "1":
        order = _program_order(init)
        assert [j_keys[n] for n in order] == list(range(len(order)))
    for name, want in j_params.items():
        np.testing.assert_allclose(got["p/" + name], want, rtol=0,
                                   atol=1e-6, err_msg=name)
