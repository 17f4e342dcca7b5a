"""The port's GSPMD tier (``byteps_tpu_torch.parallel``: the Megatron
region pairs, ``tensor_parallel``, ``fsdp``, ``spmd``; Llama and BERT
under ``tp_axis``) on four gloo ranks, against the JAX package's step
jitted with ``NamedSharding``s on four CPU devices, and against its
unsharded ``loss_fn``.

The ranks are spawned once for the module
(``_torch_port_spmd_worker.run_spmd``); while they run, this process
compiles and runs the JAX side, two programs at a time. The JAX side
runs as tests/test_fsdp.py runs it: ``remat=True``, f32,
``default_matmul_precision("float32")`` (that file records a jaxlib CPU
miscompile of the sharded step without remat). Inputs and weights are
numpy from seeds. Meshes: Llama at {dp 1, tp 2, sp 2}
(``__graft_entry__._mesh_axes(4)``) and {dp 2, tp 2}; BERT at {dp 2, tp
2} with unequal counts of masked labels on the dp ranks; FSDP at {dp 4}
(``fsdp_param_specs`` falls to dim 1 of the stacked leaves) and at {dp
2, tp 2} over the tp table, for Llama and for BERT. Tolerances, as
tests/test_torch_port_parallel.py takes them: losses 3e-4; gradients
5e-4 relative (5e-5 absolute); parameters after two SGD + momentum steps
1e-6; the slices equal JAX's ``addressable_shards`` exactly.
"""

import dataclasses
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_port_spmd_worker as W
from _torch_port_worker import save_params

LOSS_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_TOL = dict(rtol=0, atol=1e-6)
CASES = sorted(W.CASES)


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_cfg(model):
    import jax.numpy as jnp

    from byteps_tpu.models import bert, llama
    if model == "llama":
        c = llama.LlamaConfig.tiny(vocab_size=W.V, seq=W.S)
    else:
        c = bert.BertConfig.tiny(vocab_size=W.V, seq=W.S)
    return dataclasses.replace(c, dtype=jnp.float32, remat=True)


def _jax_loss(model):
    from byteps_tpu.models import bert, llama
    cfg = _jax_cfg(model)
    fn = llama.loss_fn if model == "llama" else bert.loss_fn
    return lambda p, b: fn(p, b, cfg)


def _jax_case(case, init):
    """The case's STEPS steps, jitted with the case's shardings: each
    leaf's shards by device, losses, step 0's gradients, the last
    parameters."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from byteps_tpu.parallel import sharding as sh
    from byteps_tpu.parallel.mesh import make_mesh

    model, axes, bspec, _, _ = W.CASES[case]
    mesh = make_mesh(dict(axes), jax.devices()[:W.WORLD])
    params = jax.tree.map(jnp.asarray, init)
    specs = W.specs_of(case, init, port=False)
    tx = optax.sgd(W.LR, momentum=W.MU)
    p_sh = sh.to_shardings(mesh, specs)
    o_sh = sh.to_shardings(mesh, sh.mirror_opt_specs(tx, params, specs))
    b_sh = NamedSharding(mesh, JP(*bspec))
    loss_of = _jax_loss(model)
    batch = W.batch_of(model)

    def step(p, o, b):
        loss, g = jax.value_and_grad(lambda q: loss_of(q, b))(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss, g

    stepj = jax.jit(step, in_shardings=(p_sh, o_sh, {k: b_sh for k in batch}),
                    out_shardings=(p_sh, o_sh, NamedSharding(mesh, JP()),
                                   p_sh))
    p = jax.tree.map(jax.device_put, params, p_sh)
    shards = {k: [np.asarray(s.data) for s in sorted(
        v.addressable_shards, key=lambda s: s.device.id)]
        for k, v in _jflat(p).items()}
    o = jax.tree.map(jax.device_put, tx.init(params), o_sh)
    b = {k: jax.device_put(jnp.asarray(v), b_sh) for k, v in batch.items()}
    losses, first = [], None
    with mesh:
        for _ in range(W.STEPS):
            p, o, loss, g = stepj(p, o, b)
            losses.append(float(loss))
            first = g if first is None else first
    return dict(shards=shards, losses=np.array(losses),
                grad={k: np.asarray(v) for k, v in _jflat(first).items()},
                step={k: np.asarray(v) for k, v in _jflat(p).items()})


def _jax_unsharded(model, init):
    import jax
    import jax.numpy as jnp

    loss_of = _jax_loss(model)
    batch = {k: jnp.asarray(v) for k, v in W.batch_of(model).items()}
    loss, g = jax.jit(jax.value_and_grad(lambda p: loss_of(p, batch)))(
        jax.tree.map(jnp.asarray, init))
    return dict(loss=float(loss),
                grad={k: np.asarray(v) for k, v in _jflat(g).items()})


def _np_params(shapes, seed, small):
    """Weights from numpy: norms and LayerNorm gains 1, the ``small``
    leaves N(0, 0.02^2) (Llama's embedding, BERT's biases: nonzero, so
    that their slices show), the rest N(0, 1 / fan_in) (BERT's
    embeddings too, so that the logits are far from uniform and the
    ranks' losses differ)."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name.endswith("norm") or name.endswith("_g"):
            return np.ones(shape, np.float32)
        scale = 0.02 if small(name) else 1.0 / np.sqrt(shape[-2])
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {k: ({kk: leaf(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in shapes.items()}


def _inits():
    from byteps_tpu_torch.models import bert, llama
    return {
        "llama": _np_params(llama.param_shapes(W._cfg("llama")), 0,
                            lambda n: n == "embed"),
        "bert": _np_params(bert.param_shapes(W._cfg("bert")), 1,
                           lambda n: n.startswith("b") or n.endswith("_b")
                           or n.endswith("bias")),
    }


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    tmp = tmp_path_factory.mktemp("spmd")
    inits = _inits()
    params_path = str(tmp / "params")
    for k, tree in inits.items():
        save_params(f"{params_path}.{k}.npz", tree)
    outs = [str(tmp / f"rank{r}.npz") for r in range(W.WORLD)]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=W.run_spmd, args=(
        r, W.WORLD, port, params_path, outs[r])) for r in range(W.WORLD)]
    for p in procs:
        p.start()
    jobs = {c: (lambda c=c: _jax_case(c, inits[W.CASES[c][0]]))
            for c in CASES}
    for m in ("llama", "bert"):
        jobs[f"unsharded/{m}"] = lambda m=m: _jax_unsharded(m, inits[m])

    def run(job):
        with jax.default_matmul_precision("float32"):
            return job()

    try:
        with ThreadPoolExecutor(2) as ex:
            futs = {k: ex.submit(run, job) for k, job in jobs.items()}
            jax_res = {k: f.result() for k, f in futs.items()}
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [dict(np.load(o)) for o in outs], jax_res, inits


# ----------------------------------------------------------------------- #
# the steps against the jitted JAX package
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("case", CASES)
def test_slices_equal_jax_addressable_shards(runs, case):
    ranks, jax_res, _ = runs
    shards = jax_res[case]["shards"]
    for r, out in enumerate(ranks):
        for k, per_device in shards.items():
            np.testing.assert_array_equal(out[f"{case}/slice/{k}"],
                                          per_device[r],
                                          err_msg=f"{case} {k} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax(runs, case):
    ranks, jax_res, _ = runs
    want = jax_res[case]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{case}/losses"][0],
                                   want["losses"][0], **LOSS_TOL)
        for k, g in want["grad"].items():
            np.testing.assert_allclose(out[f"{case}/grad/{k}"], g,
                                       err_msg=f"{case} {k} rank {r}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_jax_unsharded(runs, case):
    ranks, jax_res, _ = runs
    want = jax_res[f"unsharded/{W.CASES[case][0]}"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{case}/losses"][0], want["loss"],
                                   **LOSS_TOL)
        for k, g in want["grad"].items():
            np.testing.assert_allclose(out[f"{case}/grad/{k}"], g,
                                       err_msg=f"{case} {k} rank {r}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_steps_match_jax(runs, case):
    ranks, jax_res, _ = runs
    want = jax_res[case]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{case}/losses"], want["losses"],
                                   **LOSS_TOL)
        for k, p in want["step"].items():
            np.testing.assert_allclose(out[f"{case}/step/{k}"], p,
                                       err_msg=f"{case} {k} rank {r}",
                                       **STEP_TOL)


def _split_sizes(spec, axes):
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= axes[a]
    return n


@pytest.mark.parametrize("case", CASES)
def test_bytes_at_rest_and_optimizer_state_are_the_ranks_slices(runs, case):
    """Each rank holds every leaf's bytes over the product of the axes
    that split it, and the optimizer's state beside them."""
    ranks, jax_res, inits = runs
    model, axes, _, _, _ = W.CASES[case]
    specs = _jflat(W.specs_of(case, inits[model], port=True))
    want = sum(v.nbytes // _split_sizes(specs[k], axes)
               for k, v in _jflat(inits[model]).items())
    full = sum(v.nbytes for v in _jflat(inits[model]).values())
    assert want < full
    for out in ranks:
        assert int(out[f"{case}/bytes_at_rest"]) == want
        assert bool(out[f"{case}/state_local"])


def test_fsdp_specs_fall_to_the_dims_the_layout_names(runs):
    """{dp 4} falls to dim 1 of tiny()'s two stacked layers; {dp 2}
    splits the layer dim; every split leaf of the dp x tp case keeps its
    tp entry."""
    _, _, inits = runs
    dp4 = _jflat(W.specs_of("fsdp_dp4", inits["llama"], port=True))
    assert tuple(dp4["blocks/wq"]) == (None, "dp", None)
    dptp = _jflat(W.specs_of("fsdp_dp_tp", inits["llama"], port=True))
    assert tuple(dptp["blocks/wq"]) == ("dp", None, "tp")
    assert tuple(dptp["lm_head"]) == ("dp", "tp")
    assert tuple(dptp["embed"]) == ("tp", "dp")


def test_bert_loss_is_the_global_batchs_not_the_mean_of_the_ranks(runs):
    """The dp ranks' counts of masked labels differ, and the step's loss
    is sum(nll) / sum(valid) over the global batch (JAX's), which the mean
    of the ranks' own losses misses."""
    import torch

    from byteps_tpu_torch.models import bert
    ranks, jax_res, inits = runs
    labels = W.bert_batch()["labels"]
    half = W.B // 2
    counts = [(labels[:half] >= 0).sum(), (labels[half:] >= 0).sum()]
    assert counts[0] > 2 * counts[1] > 0, counts
    params = bert.params_from_jax(inits["bert"], "cpu")
    cfg = W._cfg("bert")
    with torch.no_grad():
        own = [float(bert.loss_fn(params, {
            k: torch.from_numpy(v[sl]) for k, v in W.bert_batch().items()},
            cfg)) for sl in (slice(0, half), slice(half, None))]
    got = ranks[0]["bert_dp_tp/losses"][0]
    want = jax_res["unsharded/bert"]["loss"]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    # 0.0206 here: over 10x the loss tolerance (1.8e-3 at this loss)
    tol = LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(want)
    assert abs(np.mean(own) - want) > 10 * tol


def test_tp_refuses_kv_heads_it_does_not_split_and_chunked_xent(runs):
    ranks, _, _ = runs
    for out in ranks:
        assert "n_kv_heads (2)" in str(out["refused/kv_heads"])
        assert "xent_chunks" in str(out["refused/xent_chunks"])


# ----------------------------------------------------------------------- #
# the region pairs and FSDP's collectives
# ----------------------------------------------------------------------- #

def test_megatron_regions_give_the_unsharded_grads(runs):
    ranks, _, _ = runs
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["region/megatron/y"],
                                   out["region/ref_y"], rtol=1e-5, atol=1e-5)
        for n in "xcr":
            np.testing.assert_allclose(out[f"region/megatron/g{n}"],
                                       out[f"region/ref_{n}"], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{n} rank {r}")
        # forward: one all-reduce of y [4, 8] f32 (128 B at n = 2);
        # backward: one of dx
        assert int(out["region/megatron/psum_bytes"]) == 2 * 128


def test_a_row_parallel_reduce_built_from_psum_is_tp_times_off(runs):
    """``psum``'s transpose is ``psum``: as the row-parallel reduce it
    sums the replicated cotangent over tp (= 2), and every gradient
    upstream comes out twice the true one, though the forward agrees."""
    ranks, _, _ = runs
    for out in ranks:
        np.testing.assert_allclose(out["region/psum/y"], out["region/ref_y"],
                                   rtol=1e-5, atol=1e-5)
        for n in "cr":
            np.testing.assert_allclose(out[f"region/psum/g{n}"],
                                       2 * out[f"region/ref_{n}"],
                                       rtol=1e-5, atol=1e-5)


def test_gather_from_and_scatter_to(runs):
    ranks, _, _ = runs
    full = [out["region/gather_from/y"] for out in ranks]
    for r, out in enumerate(ranks):
        d, t = out["region_coords"]
        peer = [q for q, o in enumerate(ranks)
                if o["region_coords"][0] == d and q != r][0]
        # the two tp ranks' columns put together, alike on both
        np.testing.assert_array_equal(full[r], full[peer])
        np.testing.assert_array_equal(
            out["region/scatter_to/y"], full[r][:, 3 * t:3 * (t + 1)])
        # gather_from's gradient: this rank's columns of the cotangent,
        # which scatter_to's gathers back whole on both ranks
        g = out["region/scatter_to/g"]
        np.testing.assert_array_equal(out["region/gather_from/g"],
                                      g[:, 3 * t:3 * (t + 1)])
        np.testing.assert_array_equal(g, ranks[peer]["region/scatter_to/g"])
        # 12 f32 sent by each of the two all-gathers
        assert int(out["region/gather_scatter/bytes"]) == 2 * 48


def _dp_peers(ranks, r):
    t = ranks[r]["region_coords"][1]
    return [q for q, o in enumerate(ranks) if o["region_coords"][1] == t]


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_and_reduce_scatter_are_each_others_transpose(runs, dim):
    ranks, _, _ = runs
    for r, out in enumerate(ranks):
        pair = _dp_peers(ranks, r)
        me = pair.index(r)
        x = [ranks[q][f"region/all_gather{dim}/x"] for q in pair]
        np.testing.assert_array_equal(out[f"region/all_gather{dim}/y"],
                                      np.concatenate(x, dim).astype(
                                          np.float32))
        ct = sum(ranks[q][f"region/all_gather{dim}/ct"] for q in pair)
        np.testing.assert_allclose(out[f"region/all_gather{dim}/g"],
                                   np.split(ct, 2, dim)[me], rtol=1e-6,
                                   atol=1e-6)
        big = sum(ranks[q][f"region/reduce_scatter{dim}/x"] for q in pair)
        np.testing.assert_allclose(out[f"region/reduce_scatter{dim}/y"],
                                   np.split(big, 2, dim)[me], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            out[f"region/reduce_scatter{dim}/g"],
            np.concatenate([ranks[q][f"region/all_gather{dim}/x"]
                            for q in pair], dim), rtol=1e-6, atol=1e-6)
        # 6 f32 sent forward (all-gather), 6 backward (reduce-scatter)
        assert out[f"region/all_gather{dim}/bytes"].tolist() == [24, 24]


def test_broadcast_sums_its_gradient_onto_the_root(runs):
    ranks, _, _ = runs
    for r, out in enumerate(ranks):
        pair = _dp_peers(ranks, r)
        root = pair[1]
        np.testing.assert_array_equal(out["region/broadcast/y"],
                                      ranks[root]["region/broadcast/x"]
                                      .astype(np.float32))
        ct = sum(ranks[q]["region/broadcast/ct"] for q in pair)
        want = ct if r == root else np.zeros_like(ct)
        np.testing.assert_allclose(out["region/broadcast/g"], want,
                                   rtol=1e-6, atol=1e-6)
        # the root sends 24 B forward; the other rank 24 B backward
        assert out["region/broadcast/bytes"].tolist() == (
            [24, 0] if r == root else [0, 24])


# ----------------------------------------------------------------------- #
# the heads a rank attends over
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("tp", [2, 4])
def test_a_contiguous_head_split_keeps_each_query_head_with_its_kv_head(tp):
    """Llama's grouped attention reads KV head h // groups for query head
    h (``jnp.repeat`` in JAX): rank r's columns of ``wq`` and ``wk``/
    ``wv`` (query heads [r H/tp, (r+1) H/tp), KV heads [r Hkv/tp, ...))
    attend alone to the rank's slice of the whole attention's output."""
    import torch

    from byteps_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), n_heads=8,
                              n_kv_heads=4, dtype=torch.float32)
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(2, 16, h, 16), dtype=torch.float32)
               for h in (8, 4, 4))
    whole = llama._attention(q, k, v, cfg)
    hq, hk = 8 // tp, 4 // tp
    for r in range(tp):
        mine = llama._attention(q[:, :, r * hq:(r + 1) * hq],
                                k[:, :, r * hk:(r + 1) * hk],
                                v[:, :, r * hk:(r + 1) * hk], cfg)
        np.testing.assert_allclose(mine.numpy(),
                                   whole[:, :, r * hq:(r + 1) * hq].numpy(),
                                   rtol=1e-6, atol=1e-6)
