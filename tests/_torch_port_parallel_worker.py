"""A rank of the two-process gloo group of tests/test_torch_port_parallel.py.

It runs every case of the port's parallel module (``byteps_tpu_torch.
parallel``, Llama under ``sp`` and ``pp``, MoE under ``ep``) on inputs
the parent made with numpy from seeds, and saves each rank's results to
an npz. It imports only torch, numpy and byteps_tpu_torch, so a child
starts without JAX; the input makers below are shared with the parent,
which runs the same cases through the JAX package under ``shard_map``.
"""

import numpy as np

from _torch_port_worker import _load_params

# ring attention and Ulysses: [B, S, H, D] over sp = 2
ATT_B, ATT_S, ATT_H, ATT_D = 2, 32, 4, 8
RING_CASES = [(hkv, causal) for hkv in (1, 2, 4) for causal in (True, False)]
ULY_HKV = 2
# Llama tiny() under sp = 2: [B, S] pre-shifted tokens; pp = 2, M = 2
SP_V, SP_B, SP_S = 64, 2, 64
PP_V, PP_B, PP_S, PP_M = 64, 4, 16, 2
# MoE tiny() with 4 experts under ep = 2
EP_V, EP_B, EP_S = 64, 4, 16
# the steps: SGD + momentum (Adam's g / (|g| + eps) would blow the two
# autodiffs' 1e-8 differences on near-zero gradients up)
LR, MU, STEPS = 0.05, 0.9, 2
SP_PATHS = ("ring", "ulysses", "ring_xent4")


def coll_inputs():
    """Per rank: x [4, 6] and the cotangents of each collective's
    output."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 6).astype(np.float32)
    ct = {k: rng.randn(2, *s).astype(np.float32) for k, s in
          (("psum", (4, 6)), ("pmean", (4, 6)), ("ring", (4, 6)),
           ("partial", (4, 6)), ("a2a", (2, 12)))}
    return x, ct


def att_inputs(hkv: int, seed: int):
    """Global q, k, v and the output's cotangent, [B, S, H or Hkv, D]."""
    rng = np.random.RandomState(seed)
    q = rng.randn(ATT_B, ATT_S, ATT_H, ATT_D).astype(np.float32)
    k = rng.randn(ATT_B, ATT_S, hkv, ATT_D).astype(np.float32)
    v = rng.randn(ATT_B, ATT_S, hkv, ATT_D).astype(np.float32)
    ct = rng.randn(ATT_B, ATT_S, ATT_H, ATT_D).astype(np.float32)
    return q, k, v, ct


def sp_tokens():
    t = np.random.RandomState(1).randint(0, SP_V, (SP_B, SP_S + 1))
    return t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32)


def pp_tokens():
    return np.random.RandomState(2).randint(
        0, PP_V, (PP_B, PP_S + 1)).astype(np.int32)


def ep_tokens():
    return np.random.RandomState(3).randint(
        0, EP_V, (EP_B, EP_S + 1)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy().copy()
    return out


def _sgd_steps(params, grad_fn, steps):
    """SGD + momentum (torch.optim.SGD, as optax.sgd(lr, momentum)) on the
    leaves of ``params``; ``grad_fn(params)`` gives the step's gradient
    tree. Returns the losses."""
    import torch

    leaves = [p.requires_grad_() for p in _leaves(params)]
    opt = torch.optim.SGD(leaves, lr=LR, momentum=MU)
    losses = []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        for p, g in zip(leaves, _leaves(grads)):
            p.grad = g
        opt.step()
        losses.append(float(loss))
    return np.array(losses)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _grads(loss, params):
    import torch

    leaves = _leaves(params)
    gs = torch.autograd.grad(loss, leaves)
    it = iter(gs)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(params)


def _collectives(out, rank):
    import torch

    from byteps_tpu_torch.parallel import collectives as C

    x, ct = coll_inputs()
    ops = {
        "psum": lambda t: C.psum(t, "sp"),
        "pmean": lambda t: C.pmean(t, "sp"),
        "ring": lambda t: C.ppermute(t, "sp", [(0, 1), (1, 0)]),
        "partial": lambda t: C.ppermute(t, "sp", [(0, 1)]),
        "a2a": lambda t: C.all_to_all(t, "sp", split_axis=0, concat_axis=1),
    }
    for name, fn in ops.items():
        C.reset_bytes()
        xt = torch.from_numpy(x[rank]).requires_grad_()
        y = fn(xt)
        fwd = C.bytes_moved()
        (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct[name][rank]))
        out[f"coll/{name}/y"] = y.detach().numpy()
        out[f"coll/{name}/g"] = g.numpy()
        for k, v in fwd.items():
            out[f"coll/{name}/fwd_bytes/{k}"] = np.array(v)
        for k, v in C.bytes_moved().items():
            out[f"coll/{name}/bytes/{k}"] = np.array(v)
    out["coll/axis_index"] = np.array(C.axis_index("sp"))
    out["coll/axis_size"] = np.array(C.axis_size("sp"))


def _attention(out, rank):
    import torch

    from byteps_tpu_torch.parallel.ring_attention import ring_attention
    from byteps_tpu_torch.parallel.ulysses import (make_ulysses_attn,
                                                   ulysses_attention)

    s = ATT_S // 2
    sl = slice(rank * s, (rank + 1) * s)

    def run(key, fn, hkv, seed):
        q, k, v, ct = (torch.from_numpy(a[:, sl].copy())
                       for a in att_inputs(hkv, seed))
        for t in (q, k, v):
            t.requires_grad_()
        o = fn(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), ct)
        out[f"{key}/out"] = o.detach().numpy()
        for n, g in zip("qkv", grads):
            out[f"{key}/d{n}"] = g.numpy()

    for hkv, causal in RING_CASES:
        run(f"ring/h{hkv}c{int(causal)}",
            lambda q, k, v, c=causal: ring_attention(q, k, v, "sp", c),
            hkv, 10 + hkv)
    for flash in (False, True):
        run(f"ulysses/flash{int(flash)}",
            make_ulysses_attn("sp", causal=True, flash=flash), ULY_HKV, 20)
    x = torch.zeros(1, 8, 3, 4)
    try:
        ulysses_attention(x, x, x, "sp")
        out["ulysses/indivisible_raised"] = np.array("")
    except ValueError as e:
        out["ulysses/indivisible_raised"] = np.array(str(e))


def _llama_sp(out, rank, init, mesh):
    import dataclasses

    import torch

    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.parallel import collectives as C
    from byteps_tpu_torch.parallel.ulysses import make_ulysses_attn

    inputs, targets = sp_tokens()
    s = SP_S // 2
    batch = {"inputs": torch.from_numpy(inputs[:, rank * s:(rank + 1) * s]),
             "targets": torch.from_numpy(
                 targets[:, rank * s:(rank + 1) * s])}
    base = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=SP_V,
                                                   seq=SP_S),
                               dtype=torch.float32)
    for path in SP_PATHS:
        cfg = dataclasses.replace(
            base, xent_chunks=4 if path == "ring_xent4" else 0)
        attn = make_ulysses_attn("sp") if path == "ulysses" else None

        def loss_of(p):
            return tl.loss_fn(p, batch, cfg, attn, sp_axis="sp")

        params = tl.params_from_jax(init, device="cpu")
        for p in _leaves(params):
            p.requires_grad_()
        loss = loss_of(params)
        raw = _grads(loss, params)
        out[f"sp/{path}/loss"] = np.array(float(loss))
        for k, v in _flat(raw).items():
            out[f"sp/{path}/raw/{k}"] = v
        for k, v in _flat(C.pmean(raw, "sp")).items():
            out[f"sp/{path}/grad/{k}"] = v

        def step(p):
            loss = loss_of(p)
            with torch.no_grad():
                return loss, C.pmean(_grads(loss, p), "sp")

        params = tl.params_from_jax(init, device="cpu")
        out[f"sp/{path}/step_losses"] = _sgd_steps(params, step, STEPS)
        for k, v in _flat(params).items():
            out[f"sp/{path}/step/{k}"] = v
    try:
        tl.loss_fn(tl.params_from_jax(init, device="cpu"),
                   {"tokens": torch.zeros(1, 9, dtype=torch.int64)}, base,
                   sp_axis="sp")
        out["sp/unshifted_raised"] = np.array("")
    except ValueError as e:
        out["sp/unshifted_raised"] = np.array(str(e))


def _llama_pp(out, rank, init, mesh):
    import dataclasses

    import torch

    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.parallel import pipeline as PL
    from byteps_tpu_torch.parallel import sharding as sh

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=PP_V,
                                                  seq=PP_S),
                              dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(pp_tokens())}
    specs = sh.llama_pp_param_specs()

    def loss_grads(p):
        loss = tl.loss_fn_pp(p, batch, cfg, num_microbatches=PP_M,
                             pp_axis="pp")
        g = _grads(loss, p)
        for k in ("embed", "final_norm", "lm_head"):
            g[k] = PL.replicated_grad_correction(g[k], "pp")
        return loss, g

    params = sh.place_params(tl.params_from_jax(init, device="cpu"), mesh,
                             specs)
    for p in _leaves(params):
        p.requires_grad_()
    loss, g = loss_grads(params)
    out["pp/loss"] = np.array(float(loss))
    for k, v in _flat(g).items():
        out[f"pp/grad/{k}"] = v
    out["pp/step_losses"] = _sgd_steps(params, loss_grads, STEPS)
    for k, v in _flat(sh.gather_params(params, mesh, specs)).items():
        out[f"pp/step/{k}"] = v
    try:
        PL.pipeline_forward(torch.zeros(3, 4), {"w": torch.zeros(1, 4, 4)},
                            lambda h, p: h, num_microbatches=2, axis="pp")
        out["pp/bad_microbatch_raised"] = np.array("")
    except ValueError as e:
        out["pp/bad_microbatch_raised"] = np.array(str(e))


def _moe_ep(out, rank, init, mesh):
    import dataclasses

    import torch

    from byteps_tpu_torch.models import moe as tm
    from byteps_tpu_torch.parallel import sharding as sh

    cfg = dataclasses.replace(tm.MoEConfig.tiny(vocab_size=EP_V, seq=EP_S),
                              n_experts=4, dtype=torch.float32)
    tokens = ep_tokens()
    specs = sh.moe_param_specs()
    half = EP_B // 2
    for mode, toks in (("replicated", tokens),
                       ("split", tokens[rank * half:(rank + 1) * half])):
        batch = {"tokens": torch.from_numpy(toks)}

        def loss_grads(p):
            loss = tm.loss_fn(p, batch, cfg, ep_axis="ep")
            return loss, tm.ep_grad_correction(_grads(loss, p), "ep")

        params = sh.place_params(tm.params_from_jax(init, device="cpu"),
                                 mesh, specs)
        for p in _leaves(params):
            p.requires_grad_()
        loss, g = loss_grads(params)
        out[f"ep/{mode}/loss"] = np.array(float(loss))
        for k, v in _flat(g).items():
            out[f"ep/{mode}/grad/{k}"] = v
        if mode == "split":
            out["ep/split/step_losses"] = _sgd_steps(params, loss_grads,
                                                     STEPS)
            for k, v in _flat(sh.gather_params(params, mesh,
                                               specs)).items():
                out[f"ep/split/step/{k}"] = v


def _mesh_checks(out, rank):
    import torch

    from byteps_tpu_torch.parallel import sharding as sh
    from byteps_tpu_torch.parallel.distributed import (global_batch,
                                                       process_identity)
    from byteps_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": -1, "sp": 2})
    out["mesh/wildcard"] = np.array([mesh.shape["dp"], mesh.shape["sp"]])
    tree = {"a": torch.arange(24.).reshape(4, 6), "b": torch.arange(3.)}
    specs = {"a": sh.P(None, ("dp", "sp")), "b": sh.P()}
    with mesh:
        placed = sh.place_params(tree, mesh, specs)
        back = sh.gather_params(placed, mesh, specs)
    out["mesh/placed_a"] = placed["a"].numpy()
    out["mesh/roundtrip"] = np.array(all(
        torch.equal(tree[k], back[k]) for k in tree))
    out["mesh/global_batch"] = global_batch(
        mesh, torch.arange(8).reshape(4, 2), axis="sp").numpy()
    out["mesh/identity"] = np.array(process_identity())


def _one_group(out, rank):
    """``init`` takes the job's existing group as its dp group and
    leaves it to its maker at ``shutdown``."""
    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps

    bps.init(device="cpu")
    st = bps.get_state()
    mean = bps.push_pull(torch.tensor([float(rank)])).item()
    out["state/one_group"] = np.array(
        st.group is dist.group.WORLD and st.local_rank == rank
        and st.local_size == 2 and mean == 0.5)
    bps.shutdown()
    out["state/group_kept"] = np.array(dist.is_initialized())


def run_parallel(rank: int, world: int, port: int, params_path: str,
                 out_path: str) -> None:
    """One rank: every case, on a mesh of one axis of two, named per case
    (``sp``, ``pp``, ``ep``), all made at the start by both ranks."""
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.parallel.mesh import make_mesh

    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.parallel.distributed import ensure_initialized

    torch.set_num_threads(1)    # tiny tensors; the parent compiles JAX
    # the job's one group, at the address of the BytePS port block
    ensure_initialized(Config(num_processes=world, process_id=rank,
                              coord_port=port))
    out = {}
    try:
        meshes = {ax: make_mesh({ax: 2}) for ax in ("sp", "pp", "ep")}
        with meshes["sp"]:
            _collectives(out, rank)
            _attention(out, rank)
            _llama_sp(out, rank, _load_params(f"{params_path}.sp.npz"),
                      meshes["sp"])
        with meshes["pp"]:
            _llama_pp(out, rank, _load_params(f"{params_path}.pp.npz"),
                      meshes["pp"])
        with meshes["ep"]:
            _moe_ep(out, rank, _load_params(f"{params_path}.ep.npz"),
                    meshes["ep"])
        _mesh_checks(out, rank)
        _one_group(out, rank)
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
