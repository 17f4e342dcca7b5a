"""A rank of the four-process gloo group of tests/test_torch_port_spmd.py.

It runs the port's GSPMD tier (``byteps_tpu_torch.parallel``:
tensor_parallel, fsdp, spmd, the region pairs of collectives; Llama and
BERT under ``tp_axis``) on inputs the parent made with numpy from seeds,
and saves each rank's results to an npz. It imports only torch, numpy and
byteps_tpu_torch; the input makers and the cases below are shared with
the parent, which runs the same steps through the JAX package jitted
with ``NamedSharding``s.
"""

import numpy as np

from _torch_port_worker import _load_params

WORLD = 4
# Llama tiny() and BERT tiny() in f32, remat on (the JAX side's setting)
V, B, S = 128, 4, 16
# the steps: SGD + momentum (tests/test_torch_port_parallel.py's rule)
LR, MU, STEPS = 0.05, 0.9, 2
# FSDP's size floor at tiny() (tests/test_fsdp.py takes the same)
FSDP_MIN = 128
# case -> (model, mesh axes, batch spec entries, param table, fsdp)
CASES = {
    "llama_tp_sp": ("llama", {"dp": 1, "tp": 2, "sp": 2}, ("dp", "sp"),
                    "tp", False),
    "llama_dp_tp": ("llama", {"dp": 2, "tp": 2}, ("dp",), "tp", False),
    "bert_dp_tp": ("bert", {"dp": 2, "tp": 2}, ("dp",), "tp", False),
    "fsdp_dp4": ("llama", {"dp": 4}, ("dp",), None, True),
    "fsdp_dp_tp": ("llama", {"dp": 2, "tp": 2}, ("dp",), "tp", True),
    "bert_fsdp_dp_tp": ("bert", {"dp": 2, "tp": 2}, ("dp",), "tp", True),
}


def llama_batch():
    """Pre-shifted next-token batch [B, S]."""
    t = np.random.RandomState(5).randint(0, V, (B, S + 1)).astype(np.int32)
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


def bert_batch():
    """Tokens and labels [B, S]; the first half of the batch (dp rank 0's)
    masks about half its positions, the second about a tenth, so the dp
    ranks' counts of masked labels differ."""
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, V, (B, S)).astype(np.int32)
    rate = np.where(np.arange(B) < B // 2, 0.5, 0.1)[:, None]
    labels = np.where(rng.rand(B, S) < rate, tokens, -100).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def batch_of(model):
    return llama_batch() if model == "llama" else bert_batch()


def specs_of(case, params, port: bool):
    """The case's spec tree over the parameter tree ``params`` (shapes),
    from the port's tables (``port``) or the JAX package's."""
    model, axes, _, table, fsdp = CASES[case]
    if port:
        from byteps_tpu_torch.parallel import sharding as sh
        tp = {"llama": sh.llama_param_specs, "bert": sh.bert_param_specs}
        base = tp[model]() if table else None
    else:
        from byteps_tpu.parallel import sharding as sh
        tp = {"llama": sh.llama_param_specs, "bert": sh.bert_param_specs}
        base = tp[model](None) if table else None
    if not fsdp:
        return base
    return sh.fsdp_param_specs(params, axis_size=axes["dp"],
                               base_specs=base, min_elements=FSDP_MIN)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy().copy()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    return next(it)


def _cfg(model):
    import dataclasses

    import torch

    from byteps_tpu_torch.models import bert, llama
    if model == "llama":
        c = llama.LlamaConfig.tiny(vocab_size=V, seq=S)
    else:
        c = bert.BertConfig.tiny(vocab_size=V, seq=S)
    return dataclasses.replace(c, dtype=torch.float32, remat=True)


def _loss_fn(case, cfg):
    from byteps_tpu_torch.models import bert, llama
    model, axes, _, table, _ = CASES[case]
    tp = "tp" if table else None
    if model == "bert":
        return lambda p, b: bert.loss_parts(p, b, cfg, tp_axis=tp)
    sp = "sp" if "sp" in axes else None
    return lambda p, b: llama.loss_fn(p, b, cfg, sp_axis=sp, tp_axis=tp)


def _case(out, case, mesh, init):
    """STEPS spmd steps of one case from the seeded weights: this rank's
    slices, losses, the gathered gradients of step 0, the gathered
    parameters after the steps, the bytes at rest and the optimizer
    state's shapes."""
    import torch

    from byteps_tpu_torch.models import bert, llama
    from byteps_tpu_torch.parallel import sharding as sh
    from byteps_tpu_torch.parallel.spmd import make_spmd_train_step

    model, _, bspec, _, _ = CASES[case]
    specs = specs_of(case, init, port=True)
    mod = llama if model == "llama" else bert
    params = mod.params_from_jax(init, device="cpu", mesh=mesh, specs=specs)
    for k, v in _flat(params).items():
        out[f"{case}/slice/{k}"] = v
    out[f"{case}/bytes_at_rest"] = np.array(sum(
        p.numel() * p.element_size() for p in _leaves(params)))
    leaves = [p.requires_grad_() for p in _leaves(params)]
    opt = torch.optim.SGD(leaves, lr=LR, momentum=MU)
    step = make_spmd_train_step(_loss_fn(case, _cfg(model)), opt, params,
                                mesh, specs, sh.P(*bspec))
    batch = {k: torch.from_numpy(v) for k, v in batch_of(model).items()}
    losses = []
    for i in range(STEPS):
        losses.append(float(step(batch)))
        if i == 0:
            grads = _rebuild(params, iter([p.grad for p in leaves]))
            for k, v in _flat(sh.gather_params(grads, mesh, specs)).items():
                out[f"{case}/grad/{k}"] = v
    out[f"{case}/losses"] = np.array(losses)
    for k, v in _flat(sh.gather_params(params, mesh, specs)).items():
        out[f"{case}/step/{k}"] = v
    out[f"{case}/state_local"] = np.array(all(
        opt.state[p]["momentum_buffer"].shape == p.shape for p in leaves))


def _regions(out, rank, mesh):
    """The region pairs and FSDP's collectives on the tp and dp axes of a
    {dp 2, tp 2} mesh, each against the same function computed whole in
    this process; and a row-parallel reduce built from ``psum``."""
    import torch

    from byteps_tpu_torch.parallel import collectives as C

    rng = np.random.RandomState(7)
    x, ct = rng.randn(4, 8), rng.randn(4, 8)
    wc, wr = rng.randn(8, 6), rng.randn(6, 8)
    t = mesh.axis_index("tp")
    d = mesh.axis_index("dp")

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, requires_grad=True)

    def whole():
        xs, cs, rs = f32(x), f32(wc), f32(wr)
        y = torch.tanh(xs @ cs) @ rs
        return y, torch.autograd.grad(y, (xs, cs, rs), torch.tensor(
            ct, dtype=torch.float32))

    y_ref, (gx, gc, gr) = whole()
    cols = slice(3 * t, 3 * (t + 1))
    out["region/ref_x"] = gx.numpy()
    out["region/ref_c"] = gc[:, cols].numpy()
    out["region/ref_r"] = gr[cols].numpy()
    out["region/ref_y"] = y_ref.detach().numpy()
    for name, enter, leave in (
            ("megatron", C.copy_to, C.reduce_from),
            ("psum", lambda a, ax: a, C.psum)):
        xs, cs, rs = f32(x), f32(wc[:, cols]), f32(wr[cols])
        C.reset_bytes()
        y = leave(torch.tanh(enter(xs, "tp") @ cs) @ rs, "tp")
        g = torch.autograd.grad(y, (xs, cs, rs), torch.tensor(
            ct, dtype=torch.float32))
        out[f"region/{name}/y"] = y.detach().numpy()
        for n, v in zip("xcr", g):
            out[f"region/{name}/g{n}"] = v.numpy()
        out[f"region/{name}/psum_bytes"] = np.array(C.bytes_moved()["psum"])

    # gather_from / scatter_to on the last dim over tp
    full = rng.randn(4, 6)
    cts = rng.randn(4, 6)
    xs = f32(full[:, cols])
    C.reset_bytes()
    y = C.gather_from(xs, "tp")
    (g,) = torch.autograd.grad(y, xs, torch.tensor(cts, dtype=torch.float32))
    out["region/gather_from/y"] = y.detach().numpy()
    out["region/gather_from/g"] = g.numpy()
    xs = f32(full)
    y = C.scatter_to(xs, "tp")
    (g,) = torch.autograd.grad(y, xs, torch.tensor(cts[:, cols],
                                                   dtype=torch.float32))
    out["region/scatter_to/y"] = y.detach().numpy()
    out["region/scatter_to/g"] = g.numpy()
    out["region/gather_scatter/bytes"] = np.array(
        C.bytes_moved()["all_gather"])

    # FSDP's pairs over dp: every rank's input differs (seeded by rank)
    mine = np.random.RandomState(100 + rank)
    for dim in (0, 1):
        a, c = mine.randn(2, 3), mine.randn(*((4, 3) if dim == 0
                                              else (2, 6)))
        xs = f32(a)
        C.reset_bytes()
        y = C.all_gather_dim(xs, "dp", dim)
        (g,) = torch.autograd.grad(y, xs, torch.tensor(c,
                                                       dtype=torch.float32))
        out[f"region/all_gather{dim}/x"] = a
        out[f"region/all_gather{dim}/ct"] = c
        out[f"region/all_gather{dim}/y"] = y.detach().numpy()
        out[f"region/all_gather{dim}/g"] = g.numpy()
        out[f"region/all_gather{dim}/bytes"] = np.array(
            [C.bytes_moved()[k] for k in ("all_gather", "reduce_scatter")])
        big = mine.randn(*((4, 3) if dim == 0 else (2, 6)))
        xs = f32(big)
        y = C.reduce_scatter(xs, "dp", dim)
        (g,) = torch.autograd.grad(y, xs, torch.tensor(a,
                                                       dtype=torch.float32))
        out[f"region/reduce_scatter{dim}/x"] = big
        out[f"region/reduce_scatter{dim}/y"] = y.detach().numpy()
        out[f"region/reduce_scatter{dim}/g"] = g.numpy()
    a, c = mine.randn(3, 2), mine.randn(3, 2)
    xs = f32(a)
    C.reset_bytes()
    y = C.broadcast(xs, "dp", 1)
    (g,) = torch.autograd.grad(y, xs, torch.tensor(c, dtype=torch.float32),
                               allow_unused=True)
    out["region/broadcast/x"] = a
    out["region/broadcast/ct"] = c
    out["region/broadcast/y"] = y.detach().numpy()
    out["region/broadcast/g"] = (g if g is not None
                                 else torch.zeros(3, 2)).numpy()
    out["region/broadcast/bytes"] = np.array(
        [C.bytes_moved()[k] for k in ("broadcast", "reduce")])
    out["region_coords"] = np.array([d, t])


def _refusals(out, mesh4, init):
    """What the tp path refuses: KV heads that tp does not split (tiny()
    has 2, tp = 4) and the chunked cross entropy."""
    import dataclasses

    import torch

    from byteps_tpu_torch.models import llama
    from byteps_tpu_torch.parallel import sharding as sh

    cfg = _cfg("llama")
    batch = {k: torch.from_numpy(v) for k, v in llama_batch().items()}
    for name, c, mesh in (
            ("kv_heads", cfg, mesh4),
            ("xent_chunks", dataclasses.replace(cfg, xent_chunks=4), mesh4)):
        params = llama.params_from_jax(init, "cpu", mesh=mesh,
                                       specs=sh.llama_param_specs())
        try:
            with mesh, torch.no_grad():
                llama.loss_fn(params, batch, c, tp_axis="tp")
            out[f"refused/{name}"] = np.array("")
        except ValueError as e:
            out[f"refused/{name}"] = np.array(str(e))


def run_spmd(rank: int, world: int, port: int, params_path: str,
             out_path: str) -> None:
    """One rank: every case, its mesh made by all ranks at the start."""
    import torch
    import torch.distributed as dist

    from byteps_tpu_torch.config import Config
    from byteps_tpu_torch.parallel.distributed import ensure_initialized
    from byteps_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)    # tiny tensors; the parent compiles JAX
    ensure_initialized(Config(num_processes=world, process_id=rank,
                              coord_port=port))
    out = {}
    try:
        meshes = {}
        for case, (_, axes, _, _, _) in CASES.items():
            key = tuple(axes.items())
            if key not in meshes:
                meshes[key] = make_mesh(axes)
        mesh4 = make_mesh({"tp": 4})
        inits = {m: _load_params(f"{params_path}.{m}.npz")
                 for m in ("llama", "bert")}
        for case, (model, axes, _, _, _) in CASES.items():
            _case(out, case, meshes[tuple(axes.items())], inits[model])
        with meshes[(("dp", 2), ("tp", 2))] as m:
            _regions(out, rank, m)
        _refusals(out, mesh4, inits["llama"])
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)
