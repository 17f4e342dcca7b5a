"""Two whole compressed train steps: the port against the JAX
``make_train_step`` on a one-device ``dp`` mesh.

Llama ``tiny()`` in fp32, Adam(1e-3) under the onebit + EF distributed
optimizer, with a compression threshold that compresses some leaves and
leaves others plain. ``optax.adam(1e-3)`` and ``torch.optim.Adam(lr=1e-3,
betas=(0.9, 0.999), eps=1e-8)`` are the same update up to rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import byteps_tpu_torch as bps
from byteps_tpu.jax import distributed_optimizer, init_opt_state
from byteps_tpu.jax.train import make_train_step as j_make_step
from byteps_tpu.models import llama as jl
from byteps_tpu.parallel.mesh import make_mesh
from byteps_tpu_torch.models import llama as tl
from byteps_tpu_torch.training import DistributedOptimizer, make_train_step

V, S, STEPS = 64, 32, 2
KW = {"compressor": "onebit", "ef": "vanilla"}
MIN_BYTES = 16384     # compresses embed, lm_head and the big block leaves


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_run():
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=jnp.float32)
    params = jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)
    init = jax.tree.map(np.asarray, params)
    tokens = np.random.RandomState(2).randint(0, V, (2, S + 1)) \
        .astype(np.int32)
    mesh = make_mesh(devices=jax.devices()[:1])
    tx = distributed_optimizer(optax.adam(1e-3), compression=KW,
                               params_example=params,
                               min_compress_bytes=MIN_BYTES)
    opt_state, specs = init_opt_state(tx, params, mesh)
    step = j_make_step(lambda p, b: jl.loss_fn(p, b, cfg), tx, mesh,
                       opt_specs=specs, donate=False)
    losses = []
    with jax.default_matmul_precision("float32"):
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state,
                                           {"tokens": tokens})
            losses.append(float(loss))
    errors = _flat(opt_state[0]["compress"])
    return init, tokens, losses, _flat(params), errors


def test_two_compressed_steps_match_jax(jax_run, tmp_path):
    init, tokens, j_losses, j_params, j_state = jax_run
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=V, seq=S),
                              dtype=torch.float32)
    bps.init(device="cpu", store=dist.FileStore(str(tmp_path / "s"), 1),
             rank=0, world_size=1)
    try:
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(init, device="cpu"))
        names = [n.replace(".", "/") for n, _ in model.named_parameters()]
        opt = DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8),
            compression=KW, min_compress_bytes=MIN_BYTES)
        step = make_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg), opt)
        losses = [float(step({"tokens": torch.from_numpy(tokens)}))
                  for _ in range(STEPS)]
    finally:
        bps.shutdown()

    # step 0 sees identical weights; step 1 weights differ by rounding
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    compressed = {n for n, s in zip(names, opt.compression.stacks) if s}
    assert {"embed", "lm_head", "blocks/w_gate"} <= compressed
    assert "final_norm" not in compressed
    flipped = total = 0
    for n, p in model.named_parameters():
        n = n.replace(".", "/")
        got, want = p.detach().numpy(), j_params[n]
        # Adam moves each element by about lr per step. Outside the onebit
        # leaves only rounding separates the two; inside, a gradient near
        # zero may take the other sign in the two frameworks and move its
        # element by 2 lr instead: count those, and bound their share
        off = np.abs(got - want) > 1e-6
        if n in compressed:
            flipped += int(off.sum())
            total += off.size
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=n)
    assert flipped <= 1e-3 * total, (flipped, total)
    # EF residuals after the second step: its gradients come from weights
    # that differ by rounding, so residuals differ by about 1e-6 of the
    # leaf's largest one; a flipped sign moves an element by 2 scale
    for n, st in zip(names, opt.compression.states):
        if n in compressed:
            want = j_state[f"{n}/error"]
            diff = np.abs(st["error"].numpy() - want)
            close = diff <= 1e-5 * np.abs(want).max()
            assert close.mean() >= 1 - 1e-3, (n, diff.max())
