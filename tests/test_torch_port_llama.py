"""The port's Llama against the JAX model on the CPU, in fp32.

The JAX parameters of ``LlamaConfig.tiny()`` go through
``params_from_jax``; loss and every gradient leaf must agree. One
module-scoped JAX reference is shared (a tiny Llama grad compiles in
seconds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import llama as jl
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.ops.flash_attention import make_flash_attn as t_flash

V, S = 64, 64
J_CFG = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                            dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                            dtype=torch.float32)


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
    """JAX init params, a token batch, and the JAX (loss, grads) with its
    dense attention; the JAX flash path computes the same function to
    fp32 rounding (tests/test_flash_attention.py), so one reference
    serves both of the port's paths."""
    params = jax.tree.map(np.asarray, jax.jit(
        jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG))
    tokens = np.random.RandomState(0).randint(0, V, (2, S + 1)) \
        .astype(np.int32)
    with jax.default_matmul_precision("float32"):
        loss, grads = jax.jit(jax.value_and_grad(jl.loss_fn),
                              static_argnums=2)(
            params, {"tokens": jnp.asarray(tokens)}, J_CFG)
    return params, tokens, float(loss), _flat(grads)


def _port_loss_grads(params, tokens, cfg, impl):
    model = tl.Llama(cfg, device="cpu",
                     params=tl.params_from_jax(params, device="cpu"))
    loss = tl.loss_fn(model.params(), {"tokens": torch.from_numpy(tokens)},
                      cfg, impl)
    loss.backward()
    grads = {n.replace(".", "/"): p.grad.numpy()
             for n, p in model.named_parameters()}
    return float(loss.detach()), grads


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_grad_match_jax(ref, attn, remat):
    params, tokens, want_loss, want_grads = ref
    cfg = dataclasses.replace(T_CFG, remat=remat)
    impl = t_flash(block_k=32) if attn == "flash" else None
    loss, grads = _port_loss_grads(params, tokens, cfg, impl)
    # fp32 on both sides: only summation order differs
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss, want_loss)
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()),
                                   err_msg=name)


@pytest.mark.parametrize("cfg_name", ["tiny", "small", "llama3_8b"])
def test_param_shapes_match_jax(cfg_name):
    jcfg = getattr(jl.LlamaConfig, cfg_name)()
    tcfg = getattr(tl.LlamaConfig, cfg_name)()
    shapes = jax.eval_shape(
        lambda: jl.init_params(jax.random.PRNGKey(0), jcfg))
    want = {"/".join(p.key for p in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    ts = tl.param_shapes(tcfg)
    got = {k: v for k, v in ts.items() if k != "blocks"}
    got.update({f"blocks/{k}": v for k, v in ts["blocks"].items()})
    assert got == want
    assert tcfg.head_dim == jcfg.head_dim


def test_entry_points_need_a_device_without_a_card():
    """Nothing runs on the CPU unless asked: without CUDA, a model built
    with no device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.Llama(T_CFG, generator=torch.Generator().manual_seed(0))
