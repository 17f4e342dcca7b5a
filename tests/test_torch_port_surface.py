"""The port's multi-worker public surface against the JAX package's.

- ``rank()`` and ``size()`` are global (byteps_tpu/core/state.py:759-767):
  ``worker_id * local_size + local_rank`` or BYTEPS_GLOBAL_RANK, and
  ``num_workers * local_size``;
- a mixed fleet, worker 0 the JAX package and worker 1 the port, on one
  server: the eager ``push_pull`` (f32 and bf16, named, averaged over the
  workers through the servers), ``broadcast`` from either worker,
  ``training.broadcast_parameters`` against the JAX adapter's (keys
  ``"param/<path>"``) and ``training.broadcast_object`` against its
  (``"bcastobj/<name>/len"`` and ``"/payload"``): both workers get the
  same bits;
- with one worker: a nameless ``push_pull`` over the PS raises, a
  zero-element one returns zeros and declares nothing.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.ops import push_pull as tpp
from _torch_port_ps_util import _free_port, _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401


@pytest.mark.parametrize("env,want", [
    ({"DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "1"}, (1, 2)),
    ({"DMLC_NUM_WORKER": "3", "DMLC_WORKER_ID": "2",
      "BYTEPS_GLOBAL_RANK": "5"}, (5, 3)),
    ({}, (0, 1)),
])
def test_rank_and_size_are_global(monkeypatch, env, want):
    from byteps_tpu.config import Config as JConfig
    from byteps_tpu.core.state import GlobalState as JState
    _ps_env(monkeypatch, _free_port())
    monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    js = JState()
    js.config = JConfig.from_env()
    assert (js.rank(), js.size()) == want
    bps.init(device="cpu")
    try:
        assert (bps.rank(), bps.size()) == want
        assert (bps.local_rank(), bps.local_size()) == (0, 1)
    finally:
        bps.shutdown()


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(40, 30).astype(np.float32),
            "blk": {"b": rs.randn(7).astype(np.float32),
                    "a": rs.randn(3, 5).astype(np.float32)}}


def _jax_worker(ops, xs, bf):
    import jax.numpy as jnp

    import byteps_tpu as jbps
    from byteps_tpu.jax import broadcast_object as j_bobj
    from byteps_tpu.jax import broadcast_parameters as j_bparams
    if ops == "push_pull":
        return {"pp": np.asarray(jbps.push_pull(xs[0], name="pp/x")),
                "bf": np.asarray(jbps.push_pull(
                    jnp.asarray(bf[0], jnp.bfloat16),
                    name="pp/bf").astype(jnp.float32))}
    out = {"b0": np.asarray(jbps.broadcast(xs[0], root_rank=0, name="b0")),
           "b1": np.asarray(jbps.broadcast(xs[0], root_rank=1, name="b1"))}
    tree = j_bparams(_tree(0), root_rank=0)
    out["params"] = {"w": np.asarray(tree["w"]),
                     "blk/a": np.asarray(tree["blk"]["a"]),
                     "blk/b": np.asarray(tree["blk"]["b"])}
    out["obj"] = j_bobj({"jax": list(range(3))}, root_rank=1, name="cfg")
    return out


def _port_worker(ops, xs, bf):
    if ops == "push_pull":
        return {"pp": tpp.push_pull(torch.from_numpy(xs[1]),
                                    name="pp/x").numpy(),
                "bf": bps.push_pull(
                    torch.from_numpy(bf[1]).to(torch.bfloat16),
                    name="pp/bf").float().numpy()}
    from byteps_tpu_torch.training import (broadcast_object,
                                           broadcast_parameters)
    out = {"b0": bps.broadcast(torch.from_numpy(xs[1]), root_rank=0,
                               name="b0").numpy(),
           "b1": bps.broadcast(torch.from_numpy(xs[1]), root_rank=1,
                               name="b1").numpy()}
    tree = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                {kk: torch.from_numpy(vv) for kk, vv in v.items()})
            for k, v in _tree(1).items()}
    broadcast_parameters(tree, root_rank=0)
    out["params"] = {"w": tree["w"].numpy(),
                     "blk/a": tree["blk"]["a"].numpy(),
                     "blk/b": tree["blk"]["b"].numpy()}
    out["obj"] = broadcast_object({"torch": "port", "n": 7}, root_rank=1,
                                  name="cfg")
    return out


@pytest.mark.parametrize("ops", ["push_pull", "broadcast"])
def test_mixed_fleet_eager_ops_agree(ps_lib, monkeypatch, jax_uses_port_lib,
                                     ops):
    import jax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.parallel.mesh import make_mesh

    rs = np.random.RandomState(7)
    xs = [rs.randn(33, 17).astype(np.float32) for _ in range(2)]
    bf = [rs.randn(300).astype(np.float32) for _ in range(2)]
    with ps_server(num_workers=2) as port:
        _ps_env(monkeypatch, port, num_workers=2)
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        GlobalState._instance = None
        jbps.init(mesh=make_mesh(devices=jax.devices()[:1]))
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        bps.init(device="cpu")
        try:
            def both():
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    fs = [pool.submit(_jax_worker, ops, xs, bf),
                          pool.submit(_port_worker, ops, xs, bf)]
                    return [f.result() for f in fs]

            j, t = bounded(both)
        finally:
            bps.shutdown()
            jbps.shutdown()
            GlobalState._instance = None
    if ops == "push_pull":
        np.testing.assert_array_equal(t["pp"], j["pp"])
        np.testing.assert_array_equal(t["pp"],
                                      (xs[0] + xs[1]) / np.float32(2))
        np.testing.assert_array_equal(t["bf"], j["bf"])
        want = (torch.from_numpy(bf[0]).bfloat16().float()
                + torch.from_numpy(bf[1]).bfloat16().float()) / 2
        np.testing.assert_allclose(t["bf"], want.numpy(), rtol=8e-3)
        return
    for k, src in (("b0", xs[0]), ("b1", xs[1])):
        np.testing.assert_array_equal(t[k], src, err_msg=k)
        np.testing.assert_array_equal(j[k], src, err_msg=k)
    root = _tree(0)
    for k, want in (("w", root["w"]), ("blk/a", root["blk"]["a"]),
                    ("blk/b", root["blk"]["b"])):
        np.testing.assert_array_equal(t["params"][k], want, err_msg=k)
        np.testing.assert_array_equal(j["params"][k], want, err_msg=k)
    assert t["obj"] == j["obj"] == {"torch": "port", "n": 7}


def test_one_worker_push_pull_needs_a_name_and_skips_empty(ps_lib,
                                                          monkeypatch):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            st = bps.get_state()
            with pytest.raises(ValueError, match="requires a tensor name"):
                bps.push_pull(x)
            empty = bps.push_pull(torch.empty(0, 5), name="none")
            assert empty.shape == (0, 5) and "none" not in \
                st.registry._contexts
            out = bounded(lambda: bps.push_pull(x, name="x"))
            assert st.registry.declare("x").nbytes == 48
            # one worker: no PS leg for broadcast, a plain copy
            b = bps.broadcast(x, root_rank=0)
        finally:
            bps.shutdown()
    torch.testing.assert_close(out, x, rtol=0, atol=0)
    torch.testing.assert_close(b, x, rtol=0, atol=0)
