"""The port's model zoo (MLP, VGG, ResNet, BERT, MoE) against the JAX
models on the CPU.

For each model at its ``tiny()`` size the JAX init goes through the
port's ``params_from_jax``; the inputs come from numpy seeds:

- leaf names, shapes and flatten order equal the JAX init's at every
  preset (the PS keys are ``"grad/" + path``);
- in f32 the loss and every gradient equal ``jax.value_and_grad`` to
  rtol 1e-4 and atol 1e-4 of the leaf's max |g| (as the Llama test);
  in the presets' bf16 compute, the loss and each leaf's gradient are
  no further from the f32 reference (L2) than ``BF16_FACTOR`` times the
  JAX bf16 model's own distance from it (the MLP has no bf16 preset);
- ResNet: the new batch-norm state to 1e-5; the stem pool bit-equal to
  ``lax.reduce_window(..., "SAME")`` at an even and an odd size;
- MoE: ``_route``'s dispatch mask equal to the JAX one exactly on a
  batch with tied router probabilities and with capacity drops; the
  combine mask exactly, given the same router probabilities (XLA's CPU
  ``exp`` and torch's differ in the last bit on many inputs, so the
  whole route's combine is held to 1e-6);
- two dense host-tier PS steps of ResNet ``tiny()`` (f32, SGD with
  momentum, the initial BN state each step, as examples/benchmark.py)
  through a loopback server against the JAX ``make_ps_train_step``, with
  8 KB partitions and 16 KB fusion (four buckets, three streamed
  leaves): the same keys, the buckets' included, losses to rtol 1e-5,
  parameters to atol 1e-6.

The JAX references are module-scoped fixtures.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import mlp as jmlp
from byteps_tpu.models import moe as jmoe
from byteps_tpu.models import resnet as jresnet
from byteps_tpu.models import vgg as jvgg
import byteps_tpu_torch as bps
from byteps_tpu_torch.models import bert, mlp, moe, resnet, vgg
from byteps_tpu_torch.training import make_ps_train_step
from byteps_tpu_torch.training.train import named_leaves
from _torch_port_ps_util import _ps_env, bounded, ps_server
from test_torch_port_ps import ps_lib  # noqa: F401

B = 4
# bf16: the port's L2 distance from the f32 reference, loss and each
# leaf's gradient, is at most this many times the JAX model's bf16
# distance from it (measured on this CPU: at most 1.51 times, ResNet's
# stem_bn/scale; the rest at most 1.08)
BF16_FACTOR = 3.0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------- #
# each model: its two configs, the JAX init, a batch, the two losses
# --------------------------------------------------------------------- #

def _image_batch(rs, size, n_classes):
    return {"x": rs.rand(B, size, size, 3).astype(np.float32),
            "y": rs.randint(0, n_classes, B).astype(np.int32)}


def _token_batch(rs, V, S, mlm: bool):
    toks = rs.randint(0, V, (B, S + (0 if mlm else 1))).astype(np.int32)
    if not mlm:
        return {"tokens": toks}
    labels = np.where(rs.rand(B, S) < 0.3, rs.randint(0, V, (B, S)), -1)
    return {"tokens": toks, "labels": labels.astype(np.int32)}


def _spec(name, f32: bool):
    """(jax cfg, port cfg, jax init, jax loss(params, batch), port
    loss(params, batch), batch) at ``tiny()`` (MLP: its one preset)."""
    rs = np.random.RandomState(7)
    jdt = jnp.float32 if f32 else jnp.bfloat16
    tdt = torch.float32 if f32 else torch.bfloat16
    if name == "mlp":
        jc, tc = jmlp.MLPConfig(), mlp.MLPConfig()
        batch = {"x": rs.rand(B, 784).astype(np.float32),
                 "y": rs.randint(0, 10, B).astype(np.int32)}
        return (jc, tc, jmlp.init_params, lambda p, b: jmlp.loss_fn(p, b, jc),
                lambda p, b: mlp.loss_fn(p, b, tc), batch)
    if name == "vgg":
        jc = dataclasses.replace(jvgg.VGGConfig.tiny(), dtype=jdt)
        tc = dataclasses.replace(vgg.VGGConfig.tiny(), dtype=tdt)
        return (jc, tc, jvgg.init_params, lambda p, b: jvgg.loss_fn(p, b, jc),
                lambda p, b: vgg.loss_fn(p, b, tc),
                _image_batch(rs, jc.image_size, jc.n_classes))
    if name == "resnet":
        jc = dataclasses.replace(jresnet.ResNetConfig.tiny(), dtype=jdt)
        tc = dataclasses.replace(resnet.ResNetConfig.tiny(), dtype=tdt)
        return (jc, tc, jresnet.init_params,
                lambda p, b: jresnet.loss_fn(p[0], p[1], b, jc),
                lambda p, b: resnet.loss_fn(p[0], p[1], b, tc),
                _image_batch(rs, 32, jc.n_classes))
    if name == "bert":
        jc = dataclasses.replace(jbert.BertConfig.tiny(seq=32), dtype=jdt)
        tc = dataclasses.replace(bert.BertConfig.tiny(seq=32), dtype=tdt)
        return (jc, tc, jbert.init_params,
                lambda p, b: jbert.loss_fn(p, b, jc),
                lambda p, b: bert.loss_fn(p, b, tc),
                _token_batch(rs, jc.vocab_size, 32, mlm=True))
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(seq=32), dtype=jdt)
    tc = dataclasses.replace(moe.MoEConfig.tiny(seq=32), dtype=tdt)
    return (jc, tc, jmoe.init_params, lambda p, b: jmoe.loss_fn(p, b, jc),
            lambda p, b: moe.loss_fn(p, b, tc),
            _token_batch(rs, jc.vocab_size, 32, mlm=False))


PORT = {"mlp": mlp, "vgg": vgg, "resnet": resnet, "bert": bert, "moe": moe}
MODELS = tuple(PORT)


@functools.lru_cache(maxsize=None)
def _init(name):
    """The JAX init of a model's tiny() config (the master weights are
    f32 whatever the compute dtype, so both dtypes share it)."""
    jc, _, init, *_ = _spec(name, True)
    return _np(jax.jit(init, static_argnums=1)(jax.random.PRNGKey(0), jc))


@functools.lru_cache(maxsize=None)
def _reference(name, kind):
    """The JAX batch, loss and gradients of one model and dtype, and the
    port's from the same init."""
    jc, tc, _, jloss, tloss, batch = _spec(name, kind == "f32")
    params = _init(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if name == "resnet":
        fn = jax.value_and_grad(lambda p, s, b: jloss((p, s), b),
                                has_aux=True)
        with jax.default_matmul_precision("float32"):
            (jl, jstate), jg = jax.jit(fn)(params[0], params[1], jb)
        jstate = _np(jstate)
    else:
        with jax.default_matmul_precision("float32"):
            jl, jg = jax.jit(jax.value_and_grad(jloss))(params, jb)
        jstate = None
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mod = PORT[name]
    tparams = mod.params_from_jax(params, "cpu", tc)
    if name == "resnet":
        model = resnet.ResNet(tc, "cpu", params=tparams[0], state=tparams[1])
        tl, tstate = tloss((model.params(), model.state()), tb)
    else:
        cls = {"mlp": mlp.MLP, "vgg": vgg.VGG, "bert": bert.Bert,
               "moe": moe.MoE}[name]
        model = cls(tc, "cpu", params=tparams)
        tl, tstate = tloss(model.params(), tb), None
    tl.backward()
    tg = {n.replace(".", "/"): p.grad.numpy()
          for n, p in model.named_parameters() if p.grad is not None}
    return dict(name=name, kind=kind, jloss=float(jl), tloss=float(tl.detach()),
                jgrads={k: np.asarray(v, np.float32)
                        for k, v in _flat(_np(jg)).items()},
                tgrads=tg, jstate=jstate, tstate=tstate, model=model)


@pytest.fixture(scope="module", params=[(m, f) for m in MODELS
                                        for f in ("f32", "bf16")
                                        if (m, f) != ("mlp", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def ref(request):
    return _reference(*request.param)


def test_loss_and_every_grad_match_jax(ref):
    jg, tg = dict(ref["jgrads"]), dict(ref["tgrads"])
    # bert's type_embed takes no part without type_ids: no gradient in
    # torch, zeros in JAX
    if ref["name"] == "bert":
        assert not np.any(jg.pop("type_embed"))
        assert "type_embed" not in tg
    if ref["name"] == "bert" and ref["kind"] == "f32":
        # the key bias's gradient is 0 in exact arithmetic (a constant
        # added to all of a query's logits leaves its softmax alone):
        # both packages give rounding noise, held to 0, not to each other
        for g in (jg.pop("blocks/bk"), tg.pop("blocks/bk")):
            assert float(np.abs(g).max()) <= 1e-9
    assert set(tg) == set(jg)
    loss, want = ref["tloss"], ref["jloss"]
    if ref["kind"] == "f32":
        assert abs(loss - want) <= 1e-5 * abs(want), (loss, want)
        for name, g in jg.items():
            np.testing.assert_allclose(tg[name], g, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(g).max()),
                                       err_msg=name)
        return
    # bf16 against the f32 reference: within BF16_FACTOR times the JAX
    # model's own bf16 distance from it, plus the f32 tolerance
    f32 = _reference(ref["name"], "f32")
    exact = f32["jloss"]
    assert abs(loss - exact) <= BF16_FACTOR * abs(want - exact) + \
        1e-5 * abs(exact), (loss, want, exact)
    for name, g in f32["jgrads"].items():
        if name not in tg:
            continue
        d_port = float(np.linalg.norm(tg[name] - g))
        d_jax = float(np.linalg.norm(jg[name] - g))
        assert d_port <= BF16_FACTOR * d_jax + 1e-4 * float(
            np.linalg.norm(g)), (name, d_port, d_jax)


def test_resnet_bn_state_matches_jax():
    ref = _reference("resnet", "f32")
    want = _flat(ref["jstate"])
    got = {k: v.detach().numpy() for k, v in _flat(ref["tstate"]).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5, err_msg=k)
    # the running variance moves by the biased batch variance
    assert not np.allclose(want["stem_bn/var"], 1.0)


# --------------------------------------------------------------------- #
# names, shapes and layout at every preset
# --------------------------------------------------------------------- #

PRESETS = [
    ("mlp", lambda: jmlp.MLPConfig(), lambda: mlp.MLPConfig()),
    ("vgg", jvgg.VGGConfig.tiny, vgg.VGGConfig.tiny),
    ("vgg", jvgg.VGGConfig.vgg11, vgg.VGGConfig.vgg11),
    ("vgg", jvgg.VGGConfig.vgg16, vgg.VGGConfig.vgg16),
    ("resnet", jresnet.ResNetConfig.tiny, resnet.ResNetConfig.tiny),
    ("resnet", jresnet.ResNetConfig.resnet18, resnet.ResNetConfig.resnet18),
    ("resnet", jresnet.ResNetConfig.resnet50, resnet.ResNetConfig.resnet50),
    ("bert", jbert.BertConfig.tiny, bert.BertConfig.tiny),
    ("bert", jbert.BertConfig.bert_base, bert.BertConfig.bert_base),
    ("bert", jbert.BertConfig.bert_large, bert.BertConfig.bert_large),
    ("moe", jmoe.MoEConfig.tiny, moe.MoEConfig.tiny),
    ("moe", jmoe.MoEConfig.small, moe.MoEConfig.small),
]
JAX_MOD = {"mlp": jmlp, "vgg": jvgg, "resnet": jresnet, "bert": jbert,
           "moe": jmoe}


def _meta(shapes):
    if isinstance(shapes, dict):
        return {k: _meta(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


@pytest.mark.parametrize("name,jcfg,tcfg", PRESETS,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(PRESETS)])
def test_names_shapes_and_order_equal_the_jax_init(name, jcfg, tcfg):
    jc, tc = jcfg(), tcfg()
    shapes = jax.eval_shape(
        lambda: JAX_MOD[name].init_params(jax.random.PRNGKey(0), jc))
    got = PORT[name].param_shapes(tc)
    if name == "resnet":
        (shapes, jstate), (got, tstate) = shapes, got
        assert {k: tuple(v.shape) for k, v in _flat(jstate).items()} == \
            _flat(tstate)
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want = [("/".join(p.key for p in path), tuple(x.shape))
            for path, x in leaves]
    # the PS keys, in the order both train steps declare them
    assert [(n, tuple(t.shape)) for n, t in named_leaves(_meta(got))] == want
    if name == "resnet" and tc == resnet.ResNetConfig.resnet50():
        assert len(want) == 161
    if name == "vgg" and tc == vgg.VGGConfig.vgg16():
        assert len(want) == 32 and dict(want)["fc0/w"] == (25088, 4096)


def test_modules_name_their_parameters_as_the_jax_tree():
    """The module's parameters walk the JAX paths ("." for "/"), the
    ResNet's BN state stays out of them (buffers), and a wrong shape is
    refused."""
    cfg = resnet.ResNetConfig.tiny()
    model = resnet.ResNet(cfg, "cpu", generator=torch.Generator())
    names = [n for n, _ in named_leaves(model)]
    assert names == [n for n, _ in named_leaves(model.params())]
    assert "s0b0/bn1/scale" in names and "s0b0/bn1/mean" not in names
    assert {n for n, _ in model.named_buffers()} == {
        n.replace("/", ".") for n in _flat(model.state())}
    params = _np(jax.jit(jmlp.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jmlp.MLPConfig()))
    params["w0"] = params["w0"][:, :3]
    with pytest.raises(ValueError, match="w0"):
        mlp.params_from_jax(params, "cpu", mlp.MLPConfig())


# --------------------------------------------------------------------- #
# ResNet's stem pool, MoE's routing
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_pool_equals_reduce_window_same(size, dtype):
    x = np.random.RandomState(size).randn(2, size, size, 5).astype(
        np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x, dtype), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
        (1, 2, 2, 1), "SAME").astype(jnp.float32))
    h = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = resnet.stem_pool(h).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # torch's symmetric padding=1 puts the windows elsewhere at even sizes
    sym = torch.nn.functional.max_pool2d(h, 3, 2, padding=1).permute(
        0, 2, 3, 1).float().numpy()
    assert np.array_equal(sym, want) == (size % 2 == 1)


def _route_inputs():
    """Tokens and a router whose experts 0 and 1 tie for every token
    (equal columns) and a third of whose tokens send both choices to the
    tie, so capacity runs out."""
    cfg = jmoe.MoEConfig.tiny()
    rs = np.random.RandomState(3)
    T, d, E = 48, cfg.dim, cfg.n_experts
    x = rs.randn(T, d).astype(np.float32)
    w = rs.randn(d, E).astype(np.float32) * 0.02
    w[:, 1] = w[:, 0]
    x[::3] = 0.0                        # every logit 0: a four-way tie
    cap = jmoe.capacity(cfg, T) // 2    # drops
    return cfg, x, w, cap


def test_moe_route_matches_jax_on_ties_and_drops():
    jcfg, x, w, cap = _route_inputs()
    tcfg = moe.MoEConfig.tiny()
    jd, jc, jaux = jax.jit(jmoe._route, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(w), jcfg, cap)
    jd, jc = np.asarray(jd), np.asarray(jc)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    td, tc, taux = moe._route(tx, tw, tcfg, cap)
    assert np.array_equal(td.numpy(), jd)
    # the inputs exercise both: tied first choices and dropped slots
    assert (jd.sum((1, 2)) < jcfg.top_k).any()
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # given the JAX router probabilities, the combine mask is exact
    probs = np.asarray(jax.jit(lambda a, b: jax.nn.softmax(
        a.astype(jnp.float32) @ b.astype(jnp.float32), axis=-1))(x, w))
    pd, pc, _ = moe.route_probs(torch.tensor(probs), tcfg, cap)
    assert np.array_equal(pd.numpy(), jd)
    assert np.array_equal(pc.numpy(), jc)


def test_moe_top_k_orders_ties_by_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = moe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 3],
                                                       [0, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


# --------------------------------------------------------------------- #
# two dense PS steps of ResNet tiny, port against JAX
# --------------------------------------------------------------------- #

# leaves under 16 KB fuse into buckets of at most a partition, 8 KB:
# several buckets, as ResNet-50's 161 leaves make at the defaults
LR, MU, STEPS, FUSION, PARTITION = 0.05, 0.9, 2, "16384", "8192"


def _resnet_ps_inputs():
    rs = np.random.RandomState(11)
    return _image_batch(rs, 32, 10)


@pytest.fixture(scope="module")
def jax_resnet_ps(ps_lib):  # noqa: F811
    """Two JAX ``make_ps_train_step`` steps of ResNet tiny() in f32."""
    import optax

    import byteps_tpu as jbps
    import byteps_tpu.native.build as jbuild
    from byteps_tpu.core.state import GlobalState
    from byteps_tpu.jax.train import make_ps_train_step as j_make
    from byteps_tpu.parallel.mesh import make_mesh
    from byteps_tpu.server import client as jclient

    cfg = dataclasses.replace(jresnet.ResNetConfig.tiny(), dtype=jnp.float32)
    params, state = jax.jit(jresnet.init_params, static_argnums=1)(
        jax.random.PRNGKey(5), cfg)
    init = (_np(params), _np(state))
    batch = {k: jnp.asarray(v) for k, v in _resnet_ps_inputs().items()}
    tx = optax.sgd(LR, momentum=MU)
    opt = tx.init(params)
    mesh = make_mesh(devices=jax.devices()[:1])
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbuild, jclient):
            mp.setattr(mod, "build", lambda *a, **k: ps_lib)
        mp.setenv("BYTEPS_NATIVE_CODEC", "0")
        mp.setenv("BYTEPS_LEDGER", "0")
        with ps_server() as port:
            _ps_env(mp, port)
            mp.setenv("BYTEPS_FUSION_BYTES", FUSION)
            mp.setenv("BYTEPS_PARTITION_BYTES", PARTITION)
            GlobalState._instance = None
            jbps.init()
            try:
                step = j_make(lambda p, b: jresnet.loss_fn(
                    p, state, b, cfg)[0], tx, mesh)

                def run():
                    nonlocal params, opt
                    with jax.default_matmul_precision("float32"):
                        for _ in range(STEPS):
                            params, opt, loss = step(params, opt, batch)
                            losses.append(float(loss))

                bounded(run, timeout=120)
                names = set(jbps.get_state().registry._contexts)
            finally:
                jbps.shutdown()
                GlobalState._instance = None
    return init, losses, _flat(_np(params)), names


def test_resnet_dense_ps_steps_match_jax(jax_resnet_ps, monkeypatch):
    (jparams, jstate), j_losses, j_final, j_names = jax_resnet_ps
    cfg = dataclasses.replace(resnet.ResNetConfig.tiny(),
                              dtype=torch.float32)
    params, state = resnet.params_from_jax((jparams, jstate), "cpu", cfg)
    model = resnet.ResNet(cfg, "cpu", params=params, state=state)
    state0 = model.state()
    batch = {k: torch.from_numpy(v) for k, v in _resnet_ps_inputs().items()}
    with ps_server() as port:
        _ps_env(monkeypatch, port)
        monkeypatch.setenv("BYTEPS_FUSION_BYTES", FUSION)
        monkeypatch.setenv("BYTEPS_PARTITION_BYTES", PARTITION)
        bps.init(device="cpu")
        try:
            opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MU)
            step = make_ps_train_step(
                lambda b: resnet.loss_fn(model.params(), state0, b, cfg)[0],
                opt, model.params())
            losses = bounded(lambda: [float(step(batch))
                                      for _ in range(STEPS)])
            names = set(bps.get_state().registry._contexts)
            counters = dict(step.counters)
            step.close()
        finally:
            bps.shutdown()
    assert names == j_names
    fused = [n for n in names if n.startswith("fused/")]
    assert len(fused) == counters["fused_buckets"] >= 2, (fused, counters)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    got = {n.replace(".", "/"): p.detach().numpy()
           for n, p in model.named_parameters()}
    assert set(got) == set(j_final)
    for n, w in j_final.items():
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-6, err_msg=n)
