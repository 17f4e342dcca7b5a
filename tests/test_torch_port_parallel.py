"""The port's shard_map tier (``byteps_tpu_torch.parallel``: mesh,
collectives, sharding tables, ring attention, Ulysses, the pipeline;
Llama under ``sp`` and ``pp``, MoE under ``ep``) on two gloo ranks,
against the JAX package under ``shard_map(..., check_vma=False)`` on two
CPU devices.

The ranks are spawned once for the module
(``_torch_port_parallel_worker.run_parallel``); while they run, this
process computes the JAX side. Inputs and weights are numpy from seeds
(the weights at the JAX initializers' scales), the port's through its
``params_from_jax`` and ``place_params``. Tolerances, as the JAX package's own tests take them:
attention outputs 2e-5; attention gradients 5e-4 relative; Llama and
MoE losses 3e-4; model gradients 5e-4 relative (5e-5 absolute, as
tests/test_pipeline.py); parameters after two SGD + momentum steps
1e-6 absolute (tests/test_torch_port_dense_ps.py's rule); the
collectives 1e-6 (one f32 add or none).
"""

import dataclasses
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import _torch_port_parallel_worker as PW
from _torch_port_worker import save_params

ATT_TOL = dict(rtol=2e-5, atol=2e-5)
ATT_GRAD_TOL = dict(rtol=5e-4, atol=2e-5)
LOSS_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_TOL = dict(rtol=0, atol=1e-6)


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _mesh(name):
    import jax

    from byteps_tpu.parallel.mesh import make_mesh
    return make_mesh({name: 2}, jax.devices()[:2])


def _shmap(fn, mesh, in_specs, out_specs):
    import jax
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _jax_collectives():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    x, ct = PW.coll_inputs()
    ops = {
        "psum": lambda t: jax.lax.psum(t, "sp"),
        "pmean": lambda t: jax.lax.pmean(t, "sp"),
        "ring": lambda t: jax.lax.ppermute(t, "sp", [(0, 1), (1, 0)]),
        "partial": lambda t: jax.lax.ppermute(t, "sp", [(0, 1)]),
        "a2a": lambda t: jax.lax.all_to_all(t, "sp", 0, 1, tiled=True),
    }

    def body(x, ct):
        res = {}
        for name, fn in ops.items():
            y, vjp = jax.vjp(fn, x[0])
            (g,) = vjp(ct[name][0])
            res[name] = (y[None], g[None])
        res["axis_index"] = jax.lax.axis_index("sp")[None]
        return res

    f = _shmap(body, _mesh("sp"), (JP("sp"), JP("sp")), JP("sp"))
    return jax.tree.map(np.asarray, f(jnp.asarray(x), jax.tree.map(
        jnp.asarray, ct)))


def _jax_attention():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from byteps_tpu.parallel.ring_attention import ring_attention
    from byteps_tpu.parallel.ulysses import make_ulysses_attn

    cases = {f"ring/h{hkv}c{int(c)}": (
        lambda q, k, v, c=c: ring_attention(q, k, v, "sp", c),
        PW.att_inputs(hkv, 10 + hkv)) for hkv, c in PW.RING_CASES}
    for flash in (False, True):
        cases[f"ulysses/flash{int(flash)}"] = (
            make_ulysses_attn("sp", causal=True, flash=flash),
            PW.att_inputs(PW.ULY_HKV, 20))

    def body(inputs):
        res = {}
        for key, (fn, _) in cases.items():
            q, k, v, ct = inputs[key]
            o, vjp = jax.vjp(fn, q, k, v)
            res[key] = (o,) + tuple(vjp(ct))
        return res

    spec = JP(None, "sp")
    f = _shmap(body, _mesh("sp"), (spec,), spec)
    out = f({k: tuple(jnp.asarray(a) for a in arrs)
             for k, (_, arrs) in cases.items()})
    return {k: [np.asarray(a) for a in v] for k, v in out.items()}


def _llama_cfg(V, S):
    import jax.numpy as jnp

    from byteps_tpu.models import llama as jl
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                               dtype=jnp.float32)


def _moe_cfg():
    import jax.numpy as jnp

    from byteps_tpu.models import moe as jm
    return dataclasses.replace(jm.MoEConfig.tiny(vocab_size=PW.EP_V,
                                                 seq=PW.EP_S),
                               n_experts=4, dtype=jnp.float32)


def _sgd():
    import optax
    return optax.sgd(PW.LR, momentum=PW.MU)


def _run_steps(step, params, batch, mesh, pspecs, bspec):
    """STEPS calls of a jitted ``step(p, o, batch)`` returning (p, o,
    loss, extra): losses, the first call's extra, the last params. The
    inputs are placed as the step's outputs are, so that one program
    serves every call."""
    from byteps_tpu.parallel import sharding as sh
    params = sh.place_params(params, mesh, pspecs)
    batch = sh.place_params(batch, mesh, jax_tree_specs(batch, bspec))
    opt = _sgd().init(params)
    losses, first = [], None
    for _ in range(PW.STEPS):
        params, opt, loss, extra = step(params, opt, batch)
        losses.append(float(loss))
        first = extra if first is None else first
    return np.array(losses), first, params


def jax_tree_specs(tree, spec):
    import jax
    return jax.tree.map(lambda _: spec, tree)


def _jax_llama_sp(init):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as JP

    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel.ulysses import make_ulysses_attn

    inputs, targets = PW.sp_tokens()
    batch = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    base = _llama_cfg(PW.SP_V, PW.SP_S)
    mesh = _mesh("sp")
    res = {}
    for path in PW.SP_PATHS:
        cfg = dataclasses.replace(
            base, xent_chunks=4 if path == "ring_xent4" else 0)
        attn = make_ulysses_attn("sp") if path == "ulysses" else None

        def local_step(p, o, b, cfg=cfg, attn=attn):
            loss, g = jax.value_and_grad(lambda q: jl.loss_fn(
                q, b, cfg, attn_impl=attn, sp_axis="sp"))(p)
            raw = jax.tree.map(lambda x: x[None], g)
            g = jax.lax.pmean(g, "sp")
            u, o = _sgd().update(g, o, p)
            return optax.apply_updates(p, u), o, loss, (raw, g)

        params = jax.tree.map(jnp.asarray, init)
        opt_specs = jax.tree.map(lambda _: JP(), _sgd().init(params))
        step = _shmap(local_step, mesh, (JP(), opt_specs, JP(None, "sp")),
                      (JP(), opt_specs, JP(), (JP("sp"), JP())))
        losses, (raw, g), params = _run_steps(
            step, params, batch, mesh, jax_tree_specs(params, JP()),
            JP(None, "sp"))
        res[path] = dict(losses=losses, raw=_jflat(raw), grad=_jflat(g),
                         step=_jflat(params))
    # the gradient of the whole sequence's loss, in one device
    res["unsharded"] = _jflat(jax.jit(jax.grad(lambda p: jl.loss_fn(
        p, batch, base)))(jax.tree.map(jnp.asarray, init)))
    return res


def _jax_llama_pp(init):
    import jax
    import jax.numpy as jnp
    import optax

    from byteps_tpu.models import llama as jl
    from byteps_tpu.parallel import pipeline as pl
    from byteps_tpu.parallel import sharding as sh
    from jax.sharding import PartitionSpec as JP

    cfg = _llama_cfg(PW.PP_V, PW.PP_S)
    pspecs = sh.llama_pp_param_specs()
    tx = _sgd()

    def local_step(p, o, t):
        loss, g = jax.value_and_grad(lambda q: jl.loss_fn_pp(
            q, {"tokens": t}, cfg, num_microbatches=PW.PP_M,
            pp_axis="pp"))(p)
        for k in ("embed", "final_norm", "lm_head"):
            g[k] = pl.replicated_grad_correction(g[k], "pp")
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss, g

    params = jax.tree.map(jnp.asarray, init)
    opt_specs = sh.mirror_opt_specs(tx, params, pspecs)
    mesh = _mesh("pp")
    step = _shmap(local_step, mesh, (pspecs, opt_specs, JP()),
                  (pspecs, opt_specs, JP(), pspecs))
    losses, g, params = _run_steps(step, params,
                                   jnp.asarray(PW.pp_tokens()), mesh,
                                   pspecs, JP())
    return dict(losses=losses, grad=_jflat(g), step=_jflat(params))


def _jax_moe_ep(init):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as JP

    from byteps_tpu.models import moe as jm
    from byteps_tpu.parallel import sharding as sh

    cfg = _moe_cfg()
    especs = sh.moe_param_specs()
    tx = _sgd()

    def local_step(p, o, t):
        loss, g = jax.value_and_grad(lambda q: jm.loss_fn(
            q, {"tokens": t}, cfg, ep_axis="ep"))(p)
        g = jm.ep_grad_correction(g, "ep")
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss[None], g

    params = jax.tree.map(jnp.asarray, init)
    opt_specs = sh.mirror_opt_specs(tx, params, especs)
    mesh = _mesh("ep")
    res = {}
    for mode, tspec in (("replicated", JP()), ("split", JP("ep"))):
        step = _shmap(local_step, mesh, (especs, opt_specs, tspec),
                      (especs, opt_specs, JP("ep"), especs))
        p = sh.place_params(params, mesh, especs)
        opt = tx.init(p)
        t = sh.place_params(jnp.asarray(PW.ep_tokens()), mesh, tspec)
        losses, first = [], None
        for _ in range(PW.STEPS if mode == "split" else 1):
            p, opt, loss, g = step(p, opt, t)
            losses.append(np.asarray(loss))
            first = g if first is None else first
        res[mode] = dict(losses=np.array(losses), grad=_jflat(first),
                         step=_jflat(p))
    return res


def _np_params(shapes, seed):
    """Weights from numpy at the JAX initializers' scales: norms 1, the
    embedding and the router N(0, 0.02^2), the rest N(0, 1 / fan_in)."""
    rng = np.random.RandomState(seed)

    def leaf(name, shape):
        if name.endswith("norm"):
            return np.ones(shape, np.float32)
        scale = 0.02 if name in ("embed", "router") else \
            1.0 / np.sqrt(shape[-2])
        return (rng.randn(*shape) * scale).astype(np.float32)

    return {k: ({kk: leaf(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in shapes.items()}


def _inits():
    import torch

    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.models import moe as tm

    def tcfg(V, S):
        return tl.LlamaConfig.tiny(vocab_size=V, seq=S)
    return {
        "sp": _np_params(tl.param_shapes(tcfg(PW.SP_V, PW.SP_S)), 0),
        "pp": _np_params(tl.param_shapes(tcfg(PW.PP_V, PW.PP_S)), 1),
        "ep": _np_params(tm.param_shapes(dataclasses.replace(
            tm.MoEConfig.tiny(vocab_size=PW.EP_V, seq=PW.EP_S),
            n_experts=4, dtype=torch.float32)), 2),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    tmp = tmp_path_factory.mktemp("parallel")
    inits = _inits()
    params_path = str(tmp / "params")
    for k, tree in inits.items():
        save_params(f"{params_path}.{k}.npz", tree)
    outs = [str(tmp / f"rank{r}.npz") for r in range(2)]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=PW.run_parallel, args=(
        r, 2, port, params_path, outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    jobs = {"coll": _jax_collectives, "att": _jax_attention,
            "sp": lambda: _jax_llama_sp(inits["sp"]),
            "pp": lambda: _jax_llama_pp(inits["pp"]),
            "ep": lambda: _jax_moe_ep(inits["ep"])}

    def run(job):
        with jax.default_matmul_precision("float32"):
            return job()

    try:
        # two programs compile at a time
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
    return [dict(np.load(o)) for o in outs], jax_res


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _grad_close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **GRAD_TOL)


# ----------------------------------------------------------------------- #
# the collectives
# ----------------------------------------------------------------------- #

COLL_BYTES = {   # x [4, 6] f32 = 96 B a rank; (forward, forward + backward)
    "psum": ({"psum": [96, 96]}, {"psum": [192, 192]}),
    "pmean": ({"psum": [96, 96]}, {"psum": [192, 192]}),
    "ring": ({"ppermute": [96, 96]}, {"ppermute": [192, 192]}),
    "partial": ({"ppermute": [96, 0]}, {"ppermute": [96, 96]}),
    "a2a": ({"all_to_all": [48, 48]}, {"all_to_all": [96, 96]}),
}


@pytest.mark.parametrize("op", sorted(COLL_BYTES))
def test_collective_and_its_transpose_match_jax_lax(runs, op):
    ranks, jax_res = runs
    jy, jg = jax_res["coll"][op]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"coll/{op}/y"], jy[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op} rank {r}")
        np.testing.assert_allclose(out[f"coll/{op}/g"], jg[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{op}^T rank {r}")


@pytest.mark.parametrize("op", sorted(COLL_BYTES))
def test_collective_byte_counters(runs, op):
    ranks, _ = runs
    fwd, both = COLL_BYTES[op]
    for r, out in enumerate(ranks):
        for name in ("psum", "ppermute", "all_to_all"):
            assert int(out[f"coll/{op}/fwd_bytes/{name}"]) == \
                fwd.get(name, [0, 0])[r], (op, name, r)
            assert int(out[f"coll/{op}/bytes/{name}"]) == \
                both.get(name, [0, 0])[r], (op, name, r)


def test_axis_index_and_size(runs):
    ranks, jax_res = runs
    for r, out in enumerate(ranks):
        assert int(out["coll/axis_index"]) == r == \
            int(jax_res["coll"]["axis_index"][r])
        assert int(out["coll/axis_size"]) == 2


# ----------------------------------------------------------------------- #
# ring attention and Ulysses
# ----------------------------------------------------------------------- #

def _att_check(ranks, want, key):
    o, dq, dk, dv = want
    s = PW.ATT_S // 2
    for r, out in enumerate(ranks):
        sl = slice(r * s, (r + 1) * s)
        np.testing.assert_allclose(out[f"{key}/out"], o[:, sl],
                                   err_msg=f"{key} rank {r}", **ATT_TOL)
        for n, g in zip("qkv", (dq, dk, dv)):
            np.testing.assert_allclose(out[f"{key}/d{n}"], g[:, sl],
                                       err_msg=f"{key} d{n} rank {r}",
                                       **ATT_GRAD_TOL)


@pytest.mark.parametrize("hkv,causal", PW.RING_CASES)
def test_ring_attention_matches_jax_ring(runs, hkv, causal):
    ranks, jax_res = runs
    key = f"ring/h{hkv}c{int(causal)}"
    _att_check(ranks, jax_res["att"][key], key)


@pytest.mark.parametrize("flash", [False, True])
def test_ulysses_matches_jax_ulysses(runs, flash):
    ranks, jax_res = runs
    key = f"ulysses/flash{int(flash)}"
    _att_check(ranks, jax_res["att"][key], key)


def test_ulysses_rejects_indivisible_heads(runs):
    ranks, _ = runs
    for out in ranks:
        assert "divisible" in str(out["ulysses/indivisible_raised"])


# ----------------------------------------------------------------------- #
# Llama under sp, ring and Ulysses
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("path", PW.SP_PATHS)
def test_llama_sp_loss_and_mean_grads_match_jax(runs, path):
    ranks, jax_res = runs
    want = jax_res["sp"][path]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"sp/{path}/loss"], want["losses"][0],
                                   **LOSS_TOL)
        for k, g in want["grad"].items():
            _grad_close(out[f"sp/{path}/grad/{k}"], g, f"{path} {k} r{r}")


@pytest.mark.parametrize("path", PW.SP_PATHS)
def test_llama_sp_per_rank_grads_match_jax_and_differ(runs, path):
    """Before the pmean each rank's gradient is its own part, JAX's per
    device; the two ranks' differ (the embedding's most)."""
    ranks, jax_res = runs
    raw = jax_res["sp"][path]["raw"]
    for r, out in enumerate(ranks):
        for k, g in raw.items():
            _grad_close(out[f"sp/{path}/raw/{k}"], g[r], f"{path} {k} r{r}")
    gap = np.abs(ranks[0][f"sp/{path}/raw/embed"]
                 - ranks[1][f"sp/{path}/raw/embed"]).max()
    assert gap > 1e-3 * np.abs(raw["embed"]).max(), gap


@pytest.mark.parametrize("path", PW.SP_PATHS)
def test_llama_sp_mean_grads_equal_the_unsharded_grads(runs, path):
    """The mean over ``sp`` of the ranks' gradients is the gradient of
    the whole sequence's loss, computed unsharded in JAX."""
    ranks, jax_res = runs
    for r, out in enumerate(ranks):
        for k, g in jax_res["sp"]["unsharded"].items():
            _grad_close(out[f"sp/{path}/grad/{k}"], g, f"{path} {k} r{r}")


@pytest.mark.parametrize("path", PW.SP_PATHS)
def test_llama_sp_steps_match_jax(runs, path):
    ranks, jax_res = runs
    want = jax_res["sp"][path]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"sp/{path}/step_losses"],
                                   want["losses"], **LOSS_TOL)
        for k, p in want["step"].items():
            np.testing.assert_allclose(out[f"sp/{path}/step/{k}"], p,
                                       err_msg=f"{path} {k} r{r}",
                                       **STEP_TOL)


def test_llama_sp_needs_a_preshifted_batch(runs):
    ranks, _ = runs
    for out in ranks:
        assert "pre-shifted" in str(out["sp/unshifted_raised"])


# ----------------------------------------------------------------------- #
# Llama under pp
# ----------------------------------------------------------------------- #

def test_llama_pp_loss_and_grads_match_jax(runs):
    ranks, jax_res = runs
    want = jax_res["pp"]
    L_local = 1                        # tiny()'s 2 layers over 2 stages
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["pp/loss"], want["losses"][0],
                                   **LOSS_TOL)
        for k, g in want["grad"].items():
            if k.startswith("blocks/"):
                g = g[r * L_local:(r + 1) * L_local]
            _grad_close(out[f"pp/grad/{k}"], g, f"pp {k} r{r}")


def test_llama_pp_steps_match_jax(runs):
    ranks, jax_res = runs
    want = jax_res["pp"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["pp/step_losses"], want["losses"],
                                   **LOSS_TOL)
        for k, p in want["step"].items():
            np.testing.assert_allclose(out[f"pp/step/{k}"], p,
                                       err_msg=f"pp {k} r{r}", **STEP_TOL)


def test_pipeline_rejects_a_batch_the_microbatches_do_not_divide(runs):
    ranks, _ = runs
    for out in ranks:
        assert "not divisible" in str(out["pp/bad_microbatch_raised"])


# ----------------------------------------------------------------------- #
# MoE under ep
# ----------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["replicated", "split"])
def test_moe_ep_loss_and_corrected_grads_match_jax(runs, mode):
    ranks, jax_res = runs
    want = jax_res["ep"][mode]
    E_local = 2                        # 4 experts over 2 ranks
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"ep/{mode}/loss"],
                                   want["losses"][0][r], **LOSS_TOL)
        for k, g in want["grad"].items():
            if k.split("/")[-1] in ("w_gate", "w_up", "w_down"):
                g = g[:, r * E_local:(r + 1) * E_local]
            _grad_close(out[f"ep/{mode}/grad/{k}"], g, f"{mode} {k} r{r}")


def test_moe_ep_steps_match_jax(runs):
    ranks, jax_res = runs
    want = jax_res["ep"]["split"]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["ep/split/step_losses"],
                                   want["losses"][:, r], **LOSS_TOL)
        for k, p in want["step"].items():
            np.testing.assert_allclose(out[f"ep/split/step/{k}"], p,
                                       err_msg=f"ep {k} r{r}", **STEP_TOL)


# ----------------------------------------------------------------------- #
# the mesh and the tables
# ----------------------------------------------------------------------- #

def test_make_mesh_wildcard_and_placement(runs):
    import jax

    from byteps_tpu.parallel.mesh import make_mesh
    ranks, _ = runs
    want = make_mesh({"dp": -1, "sp": 2}, jax.devices()[:2]).shape
    full = np.arange(24.).reshape(4, 6)
    for r, out in enumerate(ranks):
        assert out["mesh/wildcard"].tolist() == [want["dp"], want["sp"]]
        np.testing.assert_array_equal(out["mesh/placed_a"],
                                      full[:, 3 * r:3 * (r + 1)])
        assert bool(out["mesh/roundtrip"])


def test_global_batch_process_identity_and_one_group(runs):
    ranks, _ = runs
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["mesh/global_batch"],
                                      np.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])
        assert out["mesh/identity"].tolist() == [r, 2]
        assert bool(out["state/one_group"]) and bool(out["state/group_kept"])


def test_coordinator_address_equals_jax(monkeypatch):
    from byteps_tpu import config as jconfig
    from byteps_tpu.parallel import distributed as jd
    from byteps_tpu_torch import config
    from byteps_tpu_torch.parallel import distributed as d
    assert d.COORD_PORT_OFFSET == jd.COORD_PORT_OFFSET
    for env in ({"DMLC_PS_ROOT_URI": "10.0.0.7", "DMLC_PS_ROOT_PORT": "1234"},
                {"BYTEPS_COORD_PORT": "4321", "BYTEPS_NUM_PROCESS": "4",
                 "BYTEPS_PROCESS_ID": "3"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        mine, ref = config.Config.from_env(), jconfig.Config.from_env()
        assert d.coordinator_address(mine) == jd.coordinator_address(ref)
        assert (mine.num_processes, mine.process_id, mine.coord_port) == \
            (ref.num_processes, ref.process_id, ref.coord_port)
    assert d.process_identity() == (0, 1)
    assert not d.ensure_initialized(config.Config())


def test_make_mesh_rejects_sizes_that_do_not_multiply():
    import jax

    from byteps_tpu.parallel.mesh import make_mesh as jmake
    from byteps_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError) as port:
        make_mesh({"sp": 2}, devices=[0, 1, 2])
    with pytest.raises(ValueError) as ref:
        jmake({"sp": 2}, jax.devices()[:3])
    assert str(port.value) == str(ref.value)


def _spec_pairs(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            yield from _spec_pairs(port[k], ref[k], f"{path}/{k}")
    else:
        yield path, port, ref


TABLES = ["llama_param_specs", "bert_param_specs", "llama_pp_param_specs",
          "moe_param_specs"]


@pytest.mark.parametrize("table", TABLES)
def test_spec_tables_equal_jax(table):
    from byteps_tpu.parallel import sharding as jsh
    from byteps_tpu_torch.parallel import sharding as sh
    args = (None,) if table in ("llama_param_specs", "bert_param_specs") \
        else ()
    pairs = list(_spec_pairs(getattr(sh, table)(*args),
                             getattr(jsh, table)(*args)))
    assert pairs
    for path, p, j in pairs:
        assert isinstance(p, sh.P) and tuple(p) == tuple(j), (path, p, j)


@pytest.mark.parametrize("shard_seq", [False, True])
def test_batch_spec_equals_jax(shard_seq):
    from byteps_tpu.parallel import sharding as jsh
    from byteps_tpu_torch.parallel import sharding as sh
    assert tuple(sh.batch_spec(shard_seq)) == \
        tuple(jsh.batch_spec(shard_seq))


@pytest.mark.parametrize("base", [False, True])
def test_fsdp_specs_equal_jax_on_tiny(base):
    from byteps_tpu.parallel import sharding as jsh
    from byteps_tpu_torch.parallel import sharding as sh
    params = _inits()["sp"]
    kw = dict(axis_size=2, min_elements=128)
    port = sh.fsdp_param_specs(
        params, base_specs=sh.llama_param_specs() if base else None, **kw)
    ref = jsh.fsdp_param_specs(
        params, base_specs=jsh.llama_param_specs(None) if base else None,
        **kw)
    pairs = list(_spec_pairs(port, ref))
    assert len(pairs) == 12
    assert any("dp" in tuple(p) for _, p, _ in pairs)
    for path, p, j in pairs:
        assert tuple(p) == tuple(j), (path, p, j)


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_mirror_opt_specs_equal_jax(opt):
    import optax
    import torch

    from byteps_tpu.parallel import sharding as jsh
    from byteps_tpu_torch.parallel import sharding as sh
    params = _inits()["pp"]
    specs = sh.llama_pp_param_specs()
    tparams = {k: ({kk: torch.tensor(vv, requires_grad=True)
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else torch.tensor(v, requires_grad=True))
               for k, v in params.items()}
    leaves = PW._leaves(tparams)
    topt = (torch.optim.Adam(leaves, lr=1e-3) if opt == "adam"
            else torch.optim.SGD(leaves, lr=0.1, momentum=0.9))
    for p in leaves:
        p.grad = torch.zeros_like(p)
    topt.step()                        # torch makes the state here
    port = sh.mirror_opt_specs(topt, tparams, specs)
    tx = optax.adam(1e-3) if opt == "adam" else optax.sgd(0.1, momentum=0.9)
    ref = jsh.mirror_opt_specs(tx, params, jsh.llama_pp_param_specs())
    if opt == "adam":
        state = ref[0]
        mirrored = {"exp_avg": state.mu, "exp_avg_sq": state.nu}
        assert tuple(state.count) == ()
    else:
        mirrored = {"momentum_buffer": ref[0].trace}
    for key, tree in mirrored.items():
        pairs = list(_spec_pairs(_pick(port, key), tree))
        assert len(pairs) == 12
        for path, p, j in pairs:
            assert tuple(p) == tuple(j), (key, path, p, j)
    if opt == "adam":
        steps = list(_spec_pairs(_pick(port, "step"), _pick(port, "step")))
        assert len(steps) == 12 and all(p == () for _, p, _ in steps)


def _pick(tree, key):
    """The tree of ``key``'s spec in each parameter's state dict."""
    if key in tree and not isinstance(tree[key], dict):
        return tree[key]
    return {k: _pick(v, key) for k, v in tree.items()}
