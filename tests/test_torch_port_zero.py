"""The port's ZeRO-1 step (``init_zero_state``, ``make_zero_train_step``)
on a dp group of two gloo ranks against a local replay and against the
JAX package's ``make_zero_train_step`` on a two-device CPU mesh.

The ranks are spawned once for the module
(``_torch_port_worker.run_zero``); while they run, this process computes
the JAX reference. The tests read what the ranks saved:

- with Adam, Llama ``tiny()`` and a tree of odd-sized leaves end bit for
  bit where Adam on the group's mean gradient over the whole leaves
  leaves them (with two ranks each element of a reduce is one f32
  addition), on both ranks, and the module keeps its parameter objects;
- each rank's optimizer state is 1/N of each leaf, padded as
  ``shard_layout`` pads, and the odd leaves' shards are JAX's;
- with SGD + momentum the losses and parameters match JAX
  ``make_zero_train_step`` (Adam's g/(|g|+eps) would amplify the two
  autodiffs' 1e-8 differences on near-zero gradients).
"""

import dataclasses
import multiprocessing as mp

import numpy as np
import pytest

import _torch_port_worker as W


def _jax_cfg():
    import jax.numpy as jnp

    from byteps_tpu.models import llama as jl
    return dataclasses.replace(
        jl.LlamaConfig.tiny(vocab_size=W.ZERO_V, seq=W.ZERO_S),
        dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_zero_sgd(init):
    """JAX ``make_zero_train_step`` with SGD + momentum on the first two
    CPU devices, device d on row d of ``zero_tokens``: losses, params."""
    import jax
    import jax.numpy as jnp
    import optax

    from byteps_tpu.jax.train import init_zero_state, make_zero_train_step
    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.mesh import make_mesh

    cfg = _jax_cfg()
    mesh = make_mesh(devices=jax.devices()[:2])
    tx = optax.sgd(W.ZERO_LR, momentum=0.9)
    params = jax.tree.map(jnp.asarray, init)
    batch = {"tokens": jnp.asarray(W.zero_tokens())}
    losses = []
    with jax.default_matmul_precision("float32"):
        opt = init_zero_state(params, tx, mesh)
        step = make_zero_train_step(lambda p, b: jl.loss_fn(p, b, cfg), tx,
                                    mesh, params, donate=False)
        for _ in range(W.ZERO_SGD_STEPS):
            params, opt, loss = step(params, opt, batch)
            losses.append(float(loss))
    return np.array(losses), _flat(jax.tree.map(np.asarray, params))


def _jax_odd_shards():
    """JAX's flat shards of the odd tree's mean over two devices."""
    import jax
    from jax.sharding import PartitionSpec as P

    from byteps_tpu.ops import push_pull as jpp
    from byteps_tpu.parallel.mesh import make_mesh

    p0, _ = W.odd_tree_inputs()
    mesh = make_mesh(devices=jax.devices()[:2])
    stacked = {k: np.stack([v, v]) for k, v in p0.items()}

    def body(tree):
        tree = jax.tree.map(lambda x: x[0], tree)
        return jax.tree.map(lambda x: x[None],
                            jpp.reduce_scatter_tree(tree))

    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                                out_specs=P("dp"), check_vma=False))(stacked)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    import jax

    from byteps_tpu.models import llama as jl

    tmp = tmp_path_factory.mktemp("zero")
    init = jax.tree.map(np.asarray, jax.jit(
        jl.init_params, static_argnums=1)(jax.random.PRNGKey(3), _jax_cfg()))
    params_path = str(tmp / "params.npz")
    W.save_params(params_path, init)
    outs = [str(tmp / f"rank{r}.npz") for r in range(2)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.run_zero, args=(
        r, 2, str(tmp / "store"), params_path, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    try:
        jax_sgd = _jax_zero_sgd(init)
        jax_shards = _jax_odd_shards()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(o)) for o in outs], jax_sgd, jax_shards


@pytest.mark.parametrize("tree", ["adam", "odd"])
def test_adam_ends_bit_for_bit_on_the_replay(zero_runs, tree):
    ranks, _, _ = zero_runs
    keys = [k for k in ranks[0] if k.startswith(f"{tree}/p/")]
    assert len(keys) == (12 if tree == "adam" else len(W.ODD_SHAPES))
    for k in keys:
        for r in ranks:
            np.testing.assert_array_equal(
                r[k], r[k.replace("/p/", "/replay/")], k)
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)
    p0, _ = W.odd_tree_inputs()
    if tree == "odd":      # the steps moved the leaves
        assert all(not np.array_equal(ranks[0][f"odd/p/{k}"], v)
                   for k, v in p0.items())
    else:
        assert all(bool(r["adam/same_objects"]) for r in ranks)
        losses = [r["adam/losses"] for r in ranks]
        np.testing.assert_array_equal(losses[0], losses[1])
        assert np.all(np.isfinite(losses[0]))


def test_state_per_rank_is_one_shard_of_each_leaf(zero_runs):
    from byteps_tpu_torch.ops.push_pull import shard_layout

    ranks, _, _ = zero_runs
    r = ranks[0]
    names = r["adam/names"].tolist()
    sizes = [r[f"adam/p/{n}"].size for n in names]
    want = [shard_layout(s, 2)[0] for s in sizes]
    assert r["adam/shard_len"].tolist() == want
    assert r["adam/state_len"].tolist() == [[w, w] for w in want]
    assert int(r["adam/state_bytes"]) == 2 * 4 * sum(want)
    assert 2 * sum(want) - sum(sizes) < 2 * len(sizes)   # padding only


def test_odd_leaves_pad_as_shard_layout_and_jax(zero_runs):
    ranks, _, jax_shards = zero_runs
    p0, _ = W.odd_tree_inputs()
    # the shards after the steps: their length and padding
    for k, v in p0.items():
        n_shard = (v.size + 1) // 2
        for rank, r in enumerate(ranks):
            shard = r[f"odd/shard/{k}"]
            assert shard.shape == (n_shard,)
            flat = r[f"odd/p/{k}"].reshape(-1)
            want = np.concatenate([flat, np.zeros(2 * n_shard - v.size,
                                                  np.float32)])
            np.testing.assert_array_equal(
                shard, want[rank * n_shard:(rank + 1) * n_shard], k)
        # JAX pads the same tree alike
        assert jax_shards[k].shape == (2, n_shard)


def test_sgd_momentum_matches_jax_zero_step(zero_runs):
    ranks, (j_losses, j_params), _ = zero_runs
    for r in ranks:
        np.testing.assert_allclose(r["sgd/losses"], j_losses, rtol=1e-5)
        for name, want in j_params.items():
            np.testing.assert_allclose(r[f"sgd/p/{name}"], want, rtol=0,
                                       atol=1e-6, err_msg=name)
