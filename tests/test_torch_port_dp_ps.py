"""The port's PS train step with a ``dp`` group of two processes against
the JAX package on a two-device CPU mesh.

The group's ranks are spawned once for the module (gloo on the CPU,
``_torch_port_worker.run_dp_ps``) and run, each against its own loopback
server in this process: the shard helpers, two dense PS steps of Llama
``tiny()`` with the locality-shard export off and on, and two device-tier
steps under dithering + EF. The tests read what they saved:

- the shard helpers equal JAX's ``shard_layout``, ``reduce_scatter_tree``
  and ``all_gather_tree`` on odd sizes (padding) and on ints;
- the declared shard keys are the JAX step's, letter for letter;
- both runs match JAX ``make_ps_train_step`` on a two-device mesh with the
  same per-device batches (SGD + momentum, the tolerance of
  ``test_two_dense_ps_steps_match_jax``), and ``tiny()`` really shards;
- shard on equals shard off bit for bit, and both ranks' parameters are
  equal (with two ranks each element of the reduce is one f32 addition);
- the device tier leaves the same aggregate on both ranks, and the
  root's parameters match JAX ``make_ps_train_step`` under dithering + EF
  on a two-device mesh.

A mixed fleet (one server, ``num_workers = 2``): a JAX worker on a
two-device mesh and a two-rank torch group get the same aggregate; it
stalls if the group shows up as two PS workers.
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest

import _torch_port_worker as W
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

# the device tier's run (``_torch_port_worker.run_dp_ps``)
DEV_KW = {"compressor": "dithering", "ef": "vanilla"}
DEV_MIN_BYTES = 16384
LEAVES_SHARDED = {"blocks/w_down", "blocks/w_gate", "blocks/w_up",
                  "blocks/wo", "blocks/wq"}


def _jax_cfg():
    import jax.numpy as jnp

    from byteps_tpu.models import llama as jl
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=W.DP_V,
                                                   seq=W.DP_S),
                               dtype=jnp.float32)


def _jax_init():
    import jax

    from byteps_tpu.models import llama as jl
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), _jax_cfg())
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_ps_steps(monkeypatch, init, rows, steps, momentum, **kw):
    """JAX ``make_ps_train_step`` on a two-device mesh (device d takes row
    ``rows[d]`` of ``dp_tokens``): the losses, the parameters and the
    declared names. The caller sets the PS environment."""
    import jax
    import jax.numpy as jnp
    import optax

    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = _jax_cfg()
    params = jax.tree.map(jnp.asarray, init)
    tx = optax.sgd(W.DP_LR, momentum=momentum or None)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:2])
    tokens = W.dp_tokens()[list(rows)]
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    GlobalState._instance = None
    jbps.init()
    losses = []
    try:
        step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh, **kw)

        def run():
            nonlocal params, opt
            with jax.default_matmul_precision("float32"):
                for _ in range(steps):
                    params, opt, loss = step(params, opt, {"tokens": tokens})
                    losses.append(float(loss))

        bounded(run, timeout=120)
        names = set(jbps.get_state().registry._contexts)
    finally:
        jbps.shutdown()
        GlobalState._instance = None
    return losses, _flat(jax.tree.map(np.asarray, params)), names


def _spawn(target, args_of, n=2, timeout=150):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(n)]
    for p in procs:
        p.start()
    return procs


def _join(procs, timeout=150):
    try:
        for p in procs:
            p.join(timeout=timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory, ps_lib):
    """The group's runs (each rank's npz) and the JAX package's runs on a
    two-device mesh: dense with the shard export off and on, and the
    device tier under dithering + EF."""
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.server import client as jclient

    tmp = tmp_path_factory.mktemp("dp")
    init = _jax_init()
    params_path = str(tmp / "params.npz")
    W.save_params(params_path, init)
    outs = [str(tmp / f"rank{r}.npz") for r in range(2)]
    with ps_server() as p0, ps_server() as p1, ps_server() as p2, \
            ps_server() as p3:
        procs = _spawn(W.run_dp_ps, lambda r: (
            r, 2, str(tmp), (p0, p1, p2, p3), params_path, outs[r]))
        _join(procs)
    jax_runs = {}
    with pytest.MonkeyPatch.context() as mpatch:
        for mod in (jbuild, jclient):
            mpatch.setattr(mod, "build", lambda *a, **k: ps_lib)
        mpatch.setenv("BYTEPS_NATIVE_CODEC", "0")
        mpatch.setenv("BYTEPS_FUSION_BYTES", W.DP_FUSION)
        mpatch.setenv("BYTEPS_SHARD_MIN_BYTES", W.DP_SHARD_MIN)
        for shard in (False, True):
            with ps_server() as port:
                _ps_env(mpatch, port)
                jax_runs[shard] = _jax_ps_steps(
                    mpatch, init, (0, 1), W.DP_STEPS, W.DP_MU,
                    local_shard_export=shard)
        with ps_server() as port:
            _ps_env(mpatch, port)
            jax_runs["dev"] = _jax_ps_steps(
                mpatch, init, (0, 1), W.DP_STEPS, 0.0, compression=DEV_KW,
                min_compress_bytes=DEV_MIN_BYTES)
    return [dict(np.load(o)) for o in outs], jax_runs


def test_shard_helpers_match_jax(dp_runs):
    import jax
    from jax.sharding import PartitionSpec as P

    from byteps_tpu.ops import push_pull as jpp
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu_torch.ops import push_pull as tpp

    ranks, _ = dp_runs
    for size in (1, 7, 8, 15, 24_576_001):
        for n in (1, 2, 8):
            assert tpp.shard_layout(size, n) == jpp.shard_layout(size, n)
    mesh = make_mesh(devices=jax.devices()[:2])
    per = [W.shard_helper_inputs(r) for r in range(2)]
    stacked = {k: np.stack([p[k] for p in per]) for k in per[0]}
    like = per[0]

    def body(tree):
        tree = jax.tree.map(lambda x: x[0], tree)
        shards = jpp.reduce_scatter_tree(tree)
        full = jpp.all_gather_tree(shards, like)
        return (jax.tree.map(lambda x: x[None], shards),
                jax.tree.map(lambda x: x[None], full))

    shards, full = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("dp"),), out_specs=(P("dp"), P("dp")),
        check_vma=False))(stacked)
    for r in range(2):
        for k in like:
            np.testing.assert_array_equal(ranks[r][f"shard/{k}"],
                                          np.asarray(shards[k])[r], k)
            np.testing.assert_array_equal(ranks[r][f"gather/{k}"],
                                          np.asarray(full[k])[r], k)
    # the int leaf's mean truncates toward zero; the odd leaf is padded
    assert ranks[0]["gather/ints"].dtype == np.int32
    assert ranks[0]["shard/odd"].shape == (4,)


def test_shard_keys_are_the_jax_step_keys(dp_runs):
    ranks, jax_runs = dp_runs
    root, peer = (set(r["on/names"].tolist()) for r in ranks)
    assert root == jax_runs[True][2]
    shard_keys = {n for n in root if "@shard" in n}
    assert shard_keys == {f"grad/{leaf}@shard{k}of2"
                          for leaf in LEAVES_SHARDED for k in range(2)}
    # the peer pushes only its shards but numbers every key as the root
    # does, so a later key gets one number on both ranks
    for run in ("on", "off"):
        assert ranks[0][f"{run}/keys"].tolist() == \
            ranks[1][f"{run}/keys"].tolist()
    assert "@shard" not in "".join(sorted(set(r["off/names"].tolist())
                                          for r in ranks)[0])


@pytest.mark.parametrize("shard", ["off", "on"])
def test_two_dense_dp_steps_match_jax(dp_runs, shard):
    ranks, jax_runs = dp_runs
    j_losses, j_params, _ = jax_runs[shard == "on"]
    for r in ranks:
        np.testing.assert_allclose(r[f"{shard}/losses"], j_losses, rtol=1e-5)
        for name, want in j_params.items():
            np.testing.assert_allclose(r[f"{shard}/p/{name}"], want, rtol=0,
                                       atol=1e-6, err_msg=name)
        assert int(r[f"{shard}/shard_leaves"]) == \
            (len(LEAVES_SHARDED) if shard == "on" else 0)
        assert int(r[f"{shard}/streamed"]) == 9


def test_shard_on_equals_shard_off_on_both_ranks(dp_runs):
    ranks, _ = dp_runs
    keys = [k for k in ranks[0] if k.startswith("off/p/")]
    assert len(keys) == 12
    for k in keys:
        on = k.replace("off/", "on/")
        for r in ranks:
            np.testing.assert_array_equal(r[k], r[on], k)
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)
        np.testing.assert_array_equal(ranks[0][on], ranks[1][on], on)
    for r in ranks:
        np.testing.assert_array_equal(r["off/losses"], r["on/losses"])
    # off: the root pushes every byte; on: each rank its own halves of
    # the sharded leaves, the root the rest
    total = sum(v.size * 4 for k, v in ranks[0].items()
                if k.startswith("off/p/"))
    sharded = sum(ranks[0][f"off/p/{leaf}"].size * 4
                  for leaf in LEAVES_SHARDED)
    assert [int(r["off/bytes_pushed"]) for r in ranks] == [total, 0]
    assert [int(r["on/bytes_pushed"]) for r in ranks] == \
        [total - sharded // 2, sharded // 2]


def test_rowsparse_dp_steps_equal_the_dense_ones(dp_runs):
    """The embedding row-sparse in a group of two: the root pushes the
    group's mean of its rows (out of the shard plan), the aggregate is
    broadcast, and both ranks end bit for bit where the dense run (shard
    export on) leaves them, with one key numbering."""
    ranks, _ = dp_runs
    for r in ranks:
        for k in (k for k in r if k.startswith("on/p/")):
            np.testing.assert_array_equal(r["rs" + k[2:]], r[k], k)
        np.testing.assert_array_equal(r["rs/losses"], r["on/losses"])
        assert int(r["rs/shard_leaves"]) == \
            len([n for n in LEAVES_SHARDED if "embed" not in n])
        assert int(r["rs/streamed"]) == 8
    np.testing.assert_array_equal(ranks[0]["rs/keys"], ranks[1]["rs/keys"])


def test_device_tier_gives_both_ranks_one_aggregate(dp_runs):
    ranks, _ = dp_runs
    a, b = ranks
    assert int(a["dev/rounds"]) > 0 and int(b["dev/rounds"]) == 0
    np.testing.assert_array_equal(a["dev/grads"], b["dev/grads"])
    np.testing.assert_array_equal(a["dev/params"], b["dev/params"])
    np.testing.assert_array_equal(a["dev/losses"], b["dev/losses"])
    assert np.isfinite(a["dev/losses"]).all()


def test_device_tier_matches_jax_on_two_devices(dp_runs):
    """The group's device tier (the root compresses the group's mean
    gradient, one EF state per key, and broadcasts the aggregate) against
    JAX ``make_ps_train_step`` under dithering + EF on a two-device mesh,
    the same per-device batches, two SGD steps: the criterion of the
    one-rank ``test_two_ps_steps_match_jax``. A root that compressed its
    own gradient, or kept another EF state, moves every leaf apart."""
    ranks, jax_runs = dp_runs
    j_losses, j_params, _ = jax_runs["dev"]
    root = ranks[0]
    np.testing.assert_allclose(root["dev/losses"], j_losses, rtol=1e-5)
    compressed = set(root["dev/compressed"].tolist())
    assert {"embed", "lm_head", "blocks/w_gate"} <= compressed
    assert "final_norm" not in compressed
    flipped = total = 0
    for name, want in j_params.items():
        got = root["dev/p/" + name]
        # a gradient that rounds differently may take the other stochastic
        # level in a dithered leaf: count those; elsewhere only rounding
        off = np.abs(got - want) > 1e-6
        if name in compressed:
            flipped += int(off.sum())
            total += off.size
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)
    assert flipped <= 1e-3 * total, (flipped, total)


def test_mixed_fleet_jax_worker_and_torch_group_share_one_aggregate(
        tmp_path, ps_lib, monkeypatch):
    """Worker 0 is JAX on a two-device mesh (rows 0, 1), worker 1 a torch
    group of two ranks (rows 2, 3); every streamed leaf shards on both.
    One SGD step: both land the same aggregate, so the same parameters."""
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.server import client as jclient

    for mod in (jbuild, jclient):
        monkeypatch.setattr(mod, "build", lambda *a, **k: ps_lib)
    monkeypatch.setenv("BYTEPS_NATIVE_CODEC", "0")
    init = _jax_init()
    params_path = str(tmp_path / "params.npz")
    W.save_params(params_path, init)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    with ps_server(num_workers=2) as port:
        procs = _spawn(W.run_dp_mixed, lambda r: (
            r, 2, str(tmp_path), port, params_path, outs[r]))
        try:
            _ps_env(monkeypatch, port, num_workers=2)
            monkeypatch.setenv("DMLC_WORKER_ID", "0")
            monkeypatch.setenv("BYTEPS_FUSION_BYTES", W.DP_FUSION)
            monkeypatch.setenv("BYTEPS_SHARD_MIN_BYTES", W.DP_FUSION)
            _, j_params, names = _jax_ps_steps(monkeypatch, init, (0, 1), 1,
                                               0.0)
        finally:
            _join(procs)
    ranks = [dict(np.load(o)) for o in outs]
    assert set(ranks[0]["names"].tolist()) == names
    assert int(ranks[0]["shard_leaves"]) == 9
    moved = 0
    for name, want in j_params.items():
        a, b = ranks[0]["p/" + name], ranks[1]["p/" + name]
        np.testing.assert_array_equal(a, b, name)
        np.testing.assert_allclose(a, want, rtol=0, atol=1e-6, err_msg=name)
        moved += int((a != _flat(init)[name]).sum())
    assert moved > 0
