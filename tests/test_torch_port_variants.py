"""The port's one-device step variants against the JAX package on the
CPU, in fp32: the remat policies (``LlamaConfig.remat_policy``), the
chunked-vocab cross entropy (``xent_chunks``,
``chunked_next_token_xent``) and ``fused_adam_step``.

- each policy's loss and gradients equal full remat's bit for bit, and
  JAX's with the same policy name at the Llama tolerance; the saving
  policies really save their products (fewer ``mm`` in the backward); an
  unknown name raises in both packages;
- the chunked cross entropy matches JAX's on its own and inside
  ``loss_fn``; a vocab that does not divide takes the dense path in both;
- ``fused_adam_step`` on ``sum(p * G)``, whose gradient is G exactly in
  both autodiffs, matches JAX's parameters, mu, nu and count bit for bit
  over 5 steps; on Llama ``tiny()`` the losses of 3 steps match;
- the bias corrections equal XLA's at every count of the first 100,000
  but the two that ROADMAP §C.14 records.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import llama as jl
from byteps_tpu_torch.models import llama as tl

V, S = 64, 64
J_CFG = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                            dtype=jnp.float32, remat=True)
T_CFG = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                            dtype=torch.float32, remat=True)
POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref():
    params = jax.tree.map(np.asarray, jax.jit(
        jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG))
    tokens = np.random.RandomState(0).randint(0, V, (2, S + 1)) \
        .astype(np.int32)
    return params, tokens


def _jax_loss_grads(params, tokens, cfgs):
    """JAX's loss and gradients under each of ``cfgs``, all traced into
    one jit (one compile)."""
    with jax.default_matmul_precision("float32"):
        out = jax.jit(lambda p, b: [jax.value_and_grad(jl.loss_fn)(p, b, c)
                                    for c in cfgs])(
            params, {"tokens": jnp.asarray(tokens)})
    return [(float(loss), _flat(grads)) for loss, grads in out]


@pytest.fixture(scope="module")
def jax_policies(ref):
    """JAX's loss and gradients under each remat policy."""
    return dict(zip(POLICIES, _jax_loss_grads(
        *ref, [dataclasses.replace(J_CFG, remat_policy=p)
               for p in POLICIES])))


def _port_loss_grads(params, tokens, cfg):
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(params, device="cpu"))
    loss = tl.loss_fn(model.params(), {"tokens": torch.from_numpy(tokens)},
                      cfg)
    loss.backward()
    return loss.detach(), {n.replace(".", "/"): p.grad
                           for n, p in model.named_parameters()}


def _close_to_jax(loss, grads, want_loss, want_grads):
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_grads_equal_full_remat_and_jax(ref, jax_policies,
                                                     policy):
    params, tokens = ref
    full_loss, full = _port_loss_grads(params, tokens, T_CFG)
    loss, grads = _port_loss_grads(
        params, tokens, dataclasses.replace(T_CFG, remat_policy=policy))
    assert torch.equal(loss, full_loss)
    for name, g in full.items():
        assert torch.equal(grads[name], g), name
    _close_to_jax(loss, grads, *jax_policies[policy])


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_saving_policies_recompute_no_projection(ref):
    """The backward of full remat recomputes 6 projections of each block
    (the block's last product, ``w_down``, is needed by nothing of the
    backward, and the checkpoint stops its recompute before it under
    every policy); ``dots_with_no_batch_dims_saveable`` keeps those 6,
    ``dots_saveable`` the attention's 2 batched products too, and
    ``everything_saveable`` recomputes nothing."""
    params, tokens = ref
    counts = {}
    for policy in [None] + POLICIES:
        cfg = dataclasses.replace(T_CFG, remat_policy=policy)
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(params, device="cpu"))
        loss = tl.loss_fn(model.params(),
                          {"tokens": torch.from_numpy(tokens)}, cfg)
        with _CountMM() as c:
            loss.backward()
        counts[policy] = c.n
    L = T_CFG.n_layers
    assert counts["nothing_saveable"] == counts[None]
    assert counts[None] - counts["dots_with_no_batch_dims_saveable"] == 6 * L
    assert counts[None] - counts["dots_saveable"] == 8 * L
    assert counts["everything_saveable"] == counts["dots_saveable"]


def test_unknown_remat_policy_raises_in_both():
    with pytest.raises(ValueError, match="dots_with_no_batch_dims_saveable"):
        dataclasses.replace(T_CFG, remat_policy="dots_only")
    cfg = dataclasses.replace(J_CFG, remat_policy="dots_only")
    params = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    with pytest.raises(AttributeError):
        jax.eval_shape(lambda p: jl.loss_fn(p, {"tokens": jnp.zeros(
            (1, 9), jnp.int32)}, cfg), params)


XENT_CHUNKS = [4, 8]


def _xent_inputs():
    rng = np.random.RandomState(3)
    hidden = rng.randn(2, 16, 32).astype(np.float32)
    lm_head = (rng.randn(32, 64) / np.sqrt(32)).astype(np.float32)
    targets = rng.randint(0, 64, (2, 16)).astype(np.int32)
    return hidden, lm_head, targets


@pytest.fixture(scope="module")
def jax_xent():
    """JAX's loss and gradients for each of ``XENT_CHUNKS``, one jit."""
    hidden, lm_head, targets = _xent_inputs()
    with jax.default_matmul_precision("float32"):
        out = jax.jit(lambda h, w: [jax.value_and_grad(
            lambda h, w: jl.chunked_next_token_xent(
                h, w, jnp.asarray(targets), n), argnums=(0, 1))(h, w)
            for n in XENT_CHUNKS])(hidden, lm_head)
    return dict(zip(XENT_CHUNKS, out))


@pytest.mark.parametrize("n_chunks", XENT_CHUNKS)
def test_chunked_xent_matches_jax(jax_xent, n_chunks):
    hidden, lm_head, targets = _xent_inputs()
    want, (gh, gw) = jax_xent[n_chunks]
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(lm_head).requires_grad_()
    loss = tl.chunked_next_token_xent(h, w, torch.from_numpy(targets),
                                      n_chunks)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for got, g in ((h.grad, gh), (w.grad, gw)):
        g = np.asarray(g)
        np.testing.assert_allclose(got.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()))


def test_chunked_loss_fn_matches_jax_and_odd_vocab_is_dense(ref):
    params, tokens = ref
    loss, grads = _port_loss_grads(
        params, tokens, dataclasses.replace(T_CFG, xent_chunks=8))
    _close_to_jax(loss, grads, *_jax_loss_grads(
        params, tokens, [dataclasses.replace(J_CFG, xent_chunks=8)])[0])
    # 64 % 3 != 0: the dense path in both packages
    dense_loss, dense = _port_loss_grads(params, tokens, T_CFG)
    odd_loss, odd = _port_loss_grads(
        params, tokens, dataclasses.replace(T_CFG, xent_chunks=3))
    assert torch.equal(odd_loss, dense_loss)
    assert all(torch.equal(odd[k], dense[k]) for k in dense)
    # JAX traces the same program for 3 chunks as for none
    batch = {"tokens": jnp.asarray(tokens)}
    j_dense, j_odd = (str(jax.make_jaxpr(lambda p: jl.loss_fn(
        p, batch, dataclasses.replace(J_CFG, xent_chunks=c)))(params))
        for c in (0, 3))
    assert j_odd == j_dense


SHAPES = {"a": (37, 5), "b": (1001,), "c": (16, 64)}


def _adam_inputs():
    rng = np.random.RandomState(11)
    params = {k: (rng.randn(*s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    # gradients over ten decades, so the moments' roundings differ
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.uniform(-9, 1, s))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    return params, grads


def test_fused_adam_step_bit_for_bit_with_jax_on_exact_gradients():
    from byteps_tpu.jax.optim import fused_adam_step as j_fused
    from byteps_tpu_torch.training import fused_adam_step

    params, grads = _adam_inputs()
    j_init, j_step = j_fused(lambda p, b: sum(jnp.sum(p[k] * b[k])
                                               for k in p))
    j_step = jax.jit(j_step)
    jp = jax.tree.map(jnp.asarray, params)
    jo = j_init(jp)
    init, step = fused_adam_step(lambda p, b: sum(torch.sum(p[k] * b[k])
                                                  for k in p))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    to = init(tp)
    for i, g in enumerate(grads):
        jp, jo, _ = j_step(jp, jo, jax.tree.map(jnp.asarray, g))
        tp, to, _ = step(tp, to, {k: torch.from_numpy(v)
                                  for k, v in g.items()})
        assert to["count"] == int(jo["count"]) == i + 1
        for k in SHAPES:
            np.testing.assert_array_equal(tp[k].detach().numpy(),
                                          np.asarray(jp[k]), f"p {k} {i}")
            np.testing.assert_array_equal(
                to["mu"][k].float().numpy(),
                np.asarray(jo["mu"][k]).astype(np.float32), f"mu {k} {i}")
            np.testing.assert_array_equal(to["nu"][k].numpy(),
                                          np.asarray(jo["nu"][k]),
                                          f"nu {k} {i}")
        assert to["mu"]["a"].dtype == torch.bfloat16


def test_fused_adam_step_on_llama_matches_jax(ref):
    from byteps_tpu.jax.optim import fused_adam_step as j_fused
    from byteps_tpu_torch.training import fused_adam_step

    params, tokens = ref
    j_cfg = dataclasses.replace(J_CFG, remat=False)
    t_cfg = dataclasses.replace(T_CFG, remat=False)
    j_init, j_step = j_fused(lambda p, b: jl.loss_fn(p, b, j_cfg))
    j_step = jax.jit(j_step)
    jp = jax.tree.map(jnp.asarray, params)
    jo = j_init(jp)
    batch = {"tokens": jnp.asarray(tokens)}
    init, step = fused_adam_step(lambda p, b: tl.loss_fn(p, b, t_cfg))
    model = tl.Llama(t_cfg, device="cpu",
                     params=tl.params_from_jax(params, device="cpu"))
    tp = model.params()
    to = init(tp)
    t_batch = {"tokens": torch.from_numpy(tokens)}
    for _ in range(3):
        with jax.default_matmul_precision("float32"):
            jp, jo, j_loss = j_step(jp, jo, batch)
        tp, to, loss = step(tp, to, t_batch)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert to["count"] == 3


def test_bias_corrections_equal_xla_but_at_the_recorded_counts():
    from byteps_tpu_torch.ops.fused_adam import bias_corrections

    n = np.arange(1, 100_001, dtype=np.int32)
    xla = {b: np.asarray(jax.jit(lambda c: 1.0 - b ** c.astype(
        jnp.float32))(jnp.asarray(n))) for b in (0.9, 0.999)}
    # the same formula, vectorized: the f32 power rounded once
    f32 = np.float32
    ours = {b: f32(1) - (np.float64(f32(b)) ** n.astype(np.float64))
            .astype(f32) for b in (0.9, 0.999)}
    for c in (1, 2, 5, 100, 2958, 99_999):
        assert bias_corrections(c, 0.9, 0.999) == (float(ours[0.9][c - 1]),
                                                   float(ours[0.999][c - 1]))
    assert np.array_equal(ours[0.9], xla[0.9])
    off = np.nonzero(ours[0.999] != xla[0.999])[0] + 1
    assert off.tolist() == [2958, 3606]
    ulps = np.abs(ours[0.999].view(np.int32)[off - 1].astype(np.int64)
                  - xla[0.999].view(np.int32)[off - 1])
    assert ulps.tolist() == [1, 1]


def test_fused_adam_leaf_takes_the_twin_on_the_cpu_and_checks_inputs():
    from byteps_tpu_torch.ops import fused_adam as FA

    g = torch.randn(9)
    p, v = torch.randn(9), torch.rand(9)
    m = torch.randn(9).to(torch.bfloat16)
    want = [t.clone() for t in (p, m, v)]
    FA.fused_adam_leaf_plain(*want[:1], g, *want[1:], 1e-3, 0.9, 0.999,
                             1e-8, 0.1, 0.001)
    before = FA.fused_adam_leaf.launches
    FA.fused_adam_leaf(p, g, m, v, 1e-3, 0.9, 0.999, 1e-8, 0.1, 0.001)
    assert FA.fused_adam_leaf.launches == before
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    with pytest.raises(TypeError):
        FA.fused_adam_leaf(p.double(), g, m, v, 1e-3, 0.9, 0.999, 1e-8,
                           0.1, 0.001)
    with pytest.raises(ValueError):
        FA.fused_adam_leaf(p, g[:4], m, v, 1e-3, 0.9, 0.999, 1e-8, 0.1,
                           0.001)
