"""The port's dense parameter-server step (the host tier of
``make_ps_train_step`` with ``compression=None``) against the JAX package.

- two steps of Llama ``tiny()`` in fp32 match the JAX
  ``make_ps_train_step`` (losses to 1e-5, every parameter to 1e-6), with
  ``BYTEPS_FUSION_BYTES=16384``: the block matrices, ``embed`` and
  ``lm_head`` stream out of the backward, the three norm leaves travel
  in one fused bucket, and both packages declare the same keys, the
  bucket's name included. The optimizer is SGD with momentum, whose
  update is linear in the gradient: the two autodiffs sum in other
  orders (gradients 1e-7 apart), and Adam's g / (|g| + eps) turns that
  into a move of a hundredth of lr where a gradient element is near
  1e-8 (one element of ``blocks/w_down`` at this seed). Adam is held to
  plain local steps bit for bit below;
- the streamed export and the post-backward export give the same
  parameters bit for bit, and with one worker both equal plain local
  ``loss.backward(); optimizer.step()`` steps;
- the per-leaf optimizer step equals ``optimizer.step()`` bit for bit;
- a mixed fleet: a JAX worker and a torch worker push dense leaves and a
  fused bucket to one server through ``push_pull_async`` and get one
  aggregate;
- the step's backward hooks hold it weakly, and ``close()`` removes
  them;
- with no servers configured, every tier's step on a dp group of two
  (spawned gloo ranks) applies the mean of the ranks' gradients and
  returns the mean loss on both ranks.
"""

import concurrent.futures
import dataclasses
import gc
import hashlib
import weakref

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.training import make_ps_train_step
from byteps_tpu_torch.training.optim import make_leaf_apply
from byteps_tpu_torch.training.train import fused_key
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import jax_uses_port_lib, ps_lib  # noqa: F401

V, S, STEPS = 64, 32, 2
FUSION = "16384"
NORMS = ("grad/blocks/attn_norm", "grad/blocks/mlp_norm", "grad/final_norm")


def _cfg():
    return dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                               dtype=torch.float32)


def _tokens():
    return np.random.RandomState(2).randint(0, V, (2, S + 1)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


LR, MU = 0.05, 0.9


def jax_ps_run(monkeypatch, compression=None, device_compress=None,
               min_compress_bytes=None):
    """Two JAX ``make_ps_train_step`` steps of Llama tiny() in fp32 with
    SGD(LR, momentum MU) through a loopback server: the initial weights,
    the losses, the final parameters and the declared tensor names."""
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
        jax.random.PRNGKey(1), cfg)
    init = jax.tree.map(np.asarray, params)
    tokens = _tokens()
    tx = optax.sgd(LR, momentum=MU)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:1])
    losses = []
    monkeypatch.setenv("BYTEPS_LEDGER", "0")
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_FUSION_BYTES", FUSION)
        GlobalState._instance = None
        jbps.init()
        try:
            step = j_make(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh,
                          compression=compression,
                          device_compress=device_compress,
                          min_compress_bytes=min_compress_bytes)

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
    return init, losses, _flat(jax.tree.map(np.asarray, params)), names


def _sgd(ps):
    return torch.optim.SGD(ps, lr=LR, momentum=MU)


def _adam(ps):
    return torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def port_ps_run(monkeypatch, params, optimizer=_sgd, steps=STEPS, **kw):
    """The port's PS steps from ``params`` (a nested dict of numpy
    arrays) on the CPU: the losses, the model, the declared names, the
    step (for its counters) and the streamed export's record: the names
    in the order it first submitted them and its arena checkouts."""
    cfg = _cfg()
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(params, device="cpu"))
    tokens = torch.from_numpy(_tokens())
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_FUSION_BYTES", FUSION)
        bps.init(device="cpu")
        try:
            opt = optimizer(model.parameters())
            step = make_ps_train_step(
                lambda b: tl.loss_fn(model.params(), b, cfg), opt,
                model.params(), **kw)
            losses = bounded(lambda: [float(step({"tokens": tokens}))
                                      for _ in range(steps)])
            state = bps.get_state()
            names = set(state.registry._contexts)
            # the streamed leaves' priorities, pinned at their first
            # export: -n for the n-th leaf the backward produced
            prio = {n: state.scheduler.production_priority(c)
                    for n, c in state.registry._contexts.items()
                    if n not in NORMS and not n.startswith("fused/")}
            export = dict(order=sorted(prio, key=prio.get, reverse=True),
                          checkouts=state.arena.stats()["export_checkouts"])
            step.close()
        finally:
            bps.shutdown()
    return losses, model, names, step, export


@pytest.fixture(scope="module")
def jax_dense(ps_lib):
    """The JAX package's dense run, shared by the tests that read it."""
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.server import client as jclient
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jclient):
            mp.setattr(mod, "build", lambda *a, **k: ps_lib)
        mp.setenv("BYTEPS_NATIVE_CODEC", "0")
        return jax_ps_run(mp)


def _random_params(seed=1):
    gen = torch.Generator().manual_seed(seed)
    p = tl.init_params(_cfg(), gen, "cpu")
    return {k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy()) for k, v in p.items()}


def test_two_dense_ps_steps_match_jax(jax_dense, monkeypatch):
    init, j_losses, j_params, j_names = jax_dense
    losses, model, names, step, export = port_ps_run(monkeypatch, init)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    for n, p in model.named_parameters():
        n = n.replace(".", "/")
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    assert names == j_names
    c = step.counters
    assert (c["leaves_streamed"], c["leaves_post_backward"],
            c["fused_buckets"]) == (9, 3, 1)
    assert c["bytes_pushed"] == sum(p.numel() * 4
                                    for p in model.parameters())
    # each streamed leaf checks out its slot once a step
    assert export["checkouts"] == 9 * STEPS
    # priority follows the measured production order: the head's
    # gradient comes first out of the backward, the embedding's last
    order = export["order"]
    assert len(order) == 9
    assert (order[0], order[-1]) == ("grad/lm_head", "grad/embed")


def test_fused_bucket_key_is_the_jax_key(jax_dense):
    """The bucket of the three norm leaves has the name the JAX step
    declared, from the member names and sizes in flatten order."""
    cfg = _cfg()
    sizes = [cfg.n_layers * cfg.dim, cfg.n_layers * cfg.dim, cfg.dim]
    key = fused_key(list(zip(NORMS, sizes)))
    assert key in jax_dense[3]
    digest = hashlib.sha1(";".join(
        f"{n}:{s}" for n, s in zip(NORMS, sizes)).encode()).hexdigest()
    assert key == "fused/" + digest[:12]
    assert [n for n in jax_dense[3] if n.startswith("fused/")] == [key]


def test_streamed_export_equals_post_backward_and_local_steps(monkeypatch):
    """With one worker the aggregate is the pushed gradient, so both
    export paths give bit for bit the parameters of plain local steps."""
    params = _random_params()
    runs = {}
    for stream in (True, False):
        losses, model, _, step, _ = port_ps_run(monkeypatch, params, _adam,
                                                stream_export=stream)
        runs[stream] = (losses, [p.detach().clone()
                                 for p in model.parameters()])
        assert (step.counters["leaves_streamed"] > 0) == stream
    cfg = _cfg()
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(params, device="cpu"))
    opt = _adam(model.parameters())
    tokens = torch.from_numpy(_tokens())
    losses = []
    for _ in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = tl.loss_fn(model.params(), {"tokens": tokens}, cfg)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    for stream, (ls, ps) in runs.items():
        assert ls == losses, stream
        for a, b in zip(ps, model.parameters()):
            assert torch.equal(a, b.detach()), stream


@pytest.mark.parametrize("foreach", [True, False])
@pytest.mark.parametrize("make", [
    lambda ps, fe: torch.optim.Adam(ps, lr=1e-3, foreach=fe),
    lambda ps, fe: torch.optim.AdamW(ps, lr=1e-3, weight_decay=0.1,
                                     foreach=fe),
    lambda ps, fe: torch.optim.SGD(ps, lr=0.1, momentum=0.9, nesterov=True,
                                   foreach=fe),
], ids=["adam", "adamw", "sgd-nesterov"])
def test_leaf_apply_equals_optimizer_step(make, foreach):
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(5, 7, generator=gen), torch.randn(11, generator=gen),
            torch.randn(3, 2, 2, generator=gen)]
    fused = [torch.nn.Parameter(x.clone()) for x in init]
    leaf = [torch.nn.Parameter(x.clone()) for x in init]
    opt_f, opt_l = make(fused[:2], foreach), make(leaf[:2], foreach)
    opt_f.add_param_group({"params": fused[2:], "lr": 0.01})
    opt_l.add_param_group({"params": leaf[2:], "lr": 0.01})
    apply = make_leaf_apply(opt_l)
    for _ in range(3):
        for p, q in zip(fused, leaf):
            g = torch.randn(p.shape, generator=gen)
            p.grad, q.grad = g.clone(), g.clone()
        opt_f.step()
        for q in reversed(leaf):        # completion order, not flatten
            apply.step(q)
    for p, q in zip(fused, leaf):
        assert torch.equal(p, q)
    sf, sl = opt_f.state_dict(), opt_l.state_dict()
    assert sf["param_groups"] == sl["param_groups"]
    for k, st in sf["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sl["state"][k][name])), name


def test_other_optimizers_take_one_step_after_the_drain(monkeypatch):
    p = [torch.nn.Parameter(torch.ones(3))]
    assert make_leaf_apply(torch.optim.RMSprop(p, lr=0.1)) is None
    # the dense PS step still trains with it: one optimizer.step()
    losses, *_ = port_ps_run(
        monkeypatch, _random_params(),
        optimizer=lambda ps: torch.optim.RMSprop(ps, lr=1e-3))
    assert losses[1] < losses[0]


def test_mixed_fleet_dense_round_with_a_fused_bucket(ps_lib, monkeypatch,
                                                     jax_uses_port_lib):
    """Worker 0 is the JAX package, worker 1 the port, one server: each
    declares two leaves and a bucket of two small ones under the fused
    name of its own package, pushes them asynchronously, and both get
    the same averaged aggregate."""
    import byteps_tpu as jbps
    from byteps_tpu.core.state import GlobalState

    rs = np.random.RandomState(4)
    sizes = {"grad/w": 3000, "grad/b": 7, "grad/n": 5, "grad/v": 2500}
    xs = [{n: rs.randn(k).astype(np.float32) for n, k in sizes.items()}
          for _ in range(2)]
    small = ["grad/b", "grad/n"]
    j_bucket = "fused/" + hashlib.sha1(";".join(
        f"{n}:{sizes[n]}" for n in small).encode()).hexdigest()[:12]
    t_bucket = fused_key([(n, sizes[n]) for n in small])
    assert t_bucket == j_bucket

    def payloads(w):
        x = xs[w]
        return {"grad/w": x["grad/w"], j_bucket: np.concatenate(
            [x[n] for n in small]), "grad/v": x["grad/v"]}

    with ps_server(num_workers=2) as port:
        _ps_env(monkeypatch, port, num_workers=2)
        monkeypatch.setenv("BYTEPS_LEDGER", "0")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        GlobalState._instance = None
        jbps.init()
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        bps.init(device="cpu")
        try:
            for name in payloads(0):       # one key order on both
                jbps.declare_tensor(name)
                bps.declare_tensor(name)

            def jax_worker():
                hs = {n: jbps.push_pull_async(v, n)
                      for n, v in payloads(0).items()}
                return {n: jbps.synchronize(h) for n, h in hs.items()}

            def torch_worker():
                hs = {n: bps.push_pull_async(torch.from_numpy(v), n)
                      for n, v in payloads(1).items()}
                out = {n: bps.synchronize(h) for n, h in hs.items()}
                assert all(bps.poll(h) for h in hs.values())
                return out

            def both():
                # a key's first push is an init barrier of both workers
                with concurrent.futures.ThreadPoolExecutor(2) as pool:
                    futs = [pool.submit(jax_worker),
                            pool.submit(torch_worker)]
                    return [f.result() for f in futs]

            j_out, t_out = bounded(both)
        finally:
            bps.shutdown()
            jbps.shutdown()
            GlobalState._instance = None
    for name, want0 in payloads(0).items():
        want = (want0 + payloads(1)[name]) / np.float32(2)
        np.testing.assert_array_equal(j_out[name], t_out[name],
                                      err_msg=name)
        np.testing.assert_array_equal(t_out[name], want, err_msg=name)


def test_ps_api_round_trips_with_one_worker(monkeypatch):
    """declare_tensor fixes the key order; push_pull_async of a numpy
    array and of a CPU tensor, poll, synchronize (the input's shape back)
    and the blocking ps_round_trip all return the pushed values, which
    with one worker are the aggregate."""
    from byteps_tpu_torch.server.client import ps_round_trip
    x = np.random.RandomState(5).randn(6, 700).astype(np.float32)
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            assert [bps.declare_tensor(n).declared_key
                    for n in ("b", "a")] == [0, 1]

            def run():
                h1 = bps.push_pull_async(x, "a")
                h2 = bps.push_pull_async(torch.from_numpy(x[0]), "b",
                                         average=False)
                out1, out2 = bps.synchronize(h1), bps.synchronize(h2)
                assert bps.poll(h1) and bps.poll(h2)   # cleared: done
                return out1, out2, ps_round_trip(
                    bps.get_state(), "c", x.reshape(-1), average=True)

            out1, out2, out3 = bounded(run)
        finally:
            bps.shutdown()
    assert out1.shape == x.shape and out2.shape == (700,)
    np.testing.assert_array_equal(out1, x)
    np.testing.assert_array_equal(out2, x[0])
    np.testing.assert_array_equal(out3, x.reshape(-1))


def test_ps_api_refuses_a_device_tensor_and_unported_options(monkeypatch):
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        bps.init(device="cpu")
        try:
            with pytest.raises(TypeError, match="host tensor"):
                bps.push_pull_async(torch.zeros(4, device="meta"), "m")
            with pytest.raises(KeyError, match="never allocated"):
                bps.poll(10 ** 6)
            model = tl.Llama(_cfg(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            # rowsparse is ported: the step takes the option
            step = make_ps_train_step(lambda b: None, opt, model.params(),
                                      rowsparse_params=("embed",))
            assert step.rowsparse == ("embed",)
            step.close()
            # the locality-shard export is ported: a group of one has
            # nothing to shard, and its step takes whole-leaf keys
            step = make_ps_train_step(lambda b: None, opt, model.params(),
                                      local_shard_export=True)
            step.close()
        finally:
            bps.shutdown()


def test_step_without_servers_takes_the_dp_mean(tmp_path):
    """Two gloo ranks, each with a batch of its own and no PS servers:
    the dense, host-codec and device tiers each apply the mean of the
    two gradients (SGD, bit for bit as one ``optimizer.step()`` on that
    mean) and return the mean loss, the same on both ranks."""
    import multiprocessing as mp

    import _torch_port_worker as W

    ctx = mp.get_context("spawn")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [ctx.Process(target=W.run_ps_step_without_servers,
                         args=(r, 2, store, outs[r])) for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    got = [np.load(o) for o in outs]

    w0 = torch.from_numpy(W.ps_step_inputs(0)[0])
    grads, losses = [], []
    for r in range(2):
        w = w0.clone().requires_grad_(True)
        loss = W.ps_step_loss(w, torch.from_numpy(W.ps_step_inputs(r)[1]))
        loss.backward()
        grads.append(w.grad)
        losses.append(loss.detach())
    want_w = torch.nn.Parameter(w0.clone())
    want_w.grad = (grads[0] + grads[1]) / 2
    torch.optim.SGD([want_w], lr=W.PS_STEP_LR).step()
    want_loss = ((losses[0] + losses[1]) / 2).numpy()
    # each rank's own step would land elsewhere
    assert not torch.equal(grads[0], grads[1])
    for r in range(2):
        for tier in W.PS_STEP_TIERS:
            np.testing.assert_array_equal(got[r][tier],
                                          want_w.detach().numpy(),
                                          err_msg=f"rank {r} {tier}")
            np.testing.assert_array_equal(got[r][tier + "_loss"], want_loss,
                                          err_msg=f"rank {r} {tier}")


def test_close_removes_the_hooks_and_hooks_hold_the_step_weakly(
        monkeypatch):
    """A closed step's leaves stream no more (its hooks are gone) and it
    streams again when it runs again; a step dropped without ``close()``
    (its hooks still on the parameters) is freed all the same, and a
    second step on the same model streams as the first did."""
    model = tl.Llama(_cfg(), device="cpu", params=tl.params_from_jax(
        _random_params(), device="cpu"))
    batch = {"tokens": torch.from_numpy(_tokens())}
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_FUSION_BYTES", FUSION)
        bps.init(device="cpu")
        try:
            def make():
                return make_ps_train_step(
                    lambda b: tl.loss_fn(model.params(), b, _cfg()),
                    _sgd(model.parameters()), model.params())

            step = make()
            bounded(lambda: step(batch))
            assert step.counters["leaves_streamed"] == 9
            hooks = [len(p._post_accumulate_grad_hooks or {})
                     for p in model.parameters()]
            step.close()
            assert all(not p._post_accumulate_grad_hooks
                       for p in model.parameters())
            bounded(lambda: step(batch))       # re-armed
            assert step.counters["leaves_streamed"] == 9
            ref = weakref.ref(step)
            del step
            gc.collect()
            assert ref() is None
            second = make()
            bounded(lambda: second(batch))
            assert second.counters["leaves_streamed"] == 9
            second.close()
        finally:
            bps.shutdown()
    assert sum(hooks) == 9
