"""A rank of a two-process gloo group for the port's collective tests.

Spawned by tests/test_torch_port_compression.py and
tests/test_torch_port_dense_ps.py; it imports only torch, numpy and
byteps_tpu_torch, so a child starts without JAX.
"""

import numpy as np


def grads_for(rank: int):
    rng = np.random.RandomState(100 + rank)
    return (rng.randn(40, 30).astype(np.float32),
            rng.randn(7).astype(np.float32),
            np.array([-3 - rank, 3 + rank, 5], np.int32))


ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def run_rank(rank: int, world: int, store_path: str, out_path: str,
             kw=None) -> None:
    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.ops.compression import (compressed_psum_tree,
                                                  default_stacks)
    from byteps_tpu_torch.ops.push_pull import psum_tree
    from byteps_tpu_torch.training import broadcast_parameters

    bps.init(device="cpu", store=dist.FileStore(store_path, world),
             rank=rank, world_size=world)
    try:
        a, b, ints = (torch.from_numpy(x) for x in grads_for(rank))
        stacks = default_stacks([a, b], kw or ONEBIT_EF,
                                min_compress_bytes=1024)
        states = [s.init_state(g.numel()) if s else {}
                  for g, s in zip((a, b), stacks)]
        # this rank's payload, for the comparison with the JAX codec's
        payload, _ = stacks[0].compress(a.reshape(-1), states[0], 0)
        out, new_states = compressed_psum_tree(
            [a, b], states, stacks, bps.get_state().group)
        summed = psum_tree({"ints": ints}, average=True)
        mean = bps.push_pull(torch.tensor([float(rank)]))
        params = [torch.full((3,), float(rank))]
        broadcast_parameters(params, root_rank=1)
        np.savez(out_path, a=out[0].numpy(), b=out[1].numpy(),
                 error=new_states[0]["error"].numpy(),
                 ints=summed["ints"].numpy(), mean=mean.numpy(),
                 bcast=params[0].numpy(),
                 **{"payload_" + k: v.numpy() for k, v in payload.items()})
    finally:
        bps.shutdown()


# ``make_ps_train_step`` with no servers configured: each tier's step on
# a dp group of two, one SGD step of a linear model from one weight and
# a batch of each rank's own
PS_STEP_TIERS = {
    "dense": {},
    "host_codec": {"compression": {"compressor": "onebit", "ef": "vanilla"},
                   "device_compress": False},
    "device": {"compression": {"compressor": "onebit", "ef": "vanilla"}},
}
PS_STEP_LR = 0.5


def ps_step_inputs(rank: int):
    """(the shared initial weight, rank ``rank``'s batch)."""
    w = np.random.RandomState(200).randn(6, 3).astype(np.float32)
    x = np.random.RandomState(300 + rank).randn(5, 6).astype(np.float32)
    return w, x


def ps_step_loss(w, x):
    return ((x @ w) ** 2).mean()


def run_ps_step_without_servers(rank: int, world: int, store_path: str,
                                out_path: str) -> None:
    import os

    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.training import make_ps_train_step

    for k in ("DMLC_NUM_SERVER", "DMLC_ROLE"):
        os.environ.pop(k, None)
    bps.init(device="cpu", store=dist.FileStore(store_path, world),
             rank=rank, world_size=world)
    try:
        w0, x = (torch.from_numpy(a) for a in ps_step_inputs(rank))
        out = {}
        for tier, kw in PS_STEP_TIERS.items():
            w = torch.nn.Parameter(w0.clone())
            step = make_ps_train_step(lambda b, w=w: ps_step_loss(w, b),
                                      torch.optim.SGD([w], lr=PS_STEP_LR),
                                      {"w": w}, **kw)
            loss = step(x)
            step.close()
            out[tier] = w.detach().numpy()
            out[tier + "_loss"] = loss.numpy()
        np.savez(out_path, **out)
    finally:
        bps.shutdown()


# --------------------------------------------------------------------- #
# PS mode with a dp group of two (tests/test_torch_port_dp_ps.py)
# --------------------------------------------------------------------- #

# the dense runs' knobs: tiny()'s leaves of 16 KB and up stream, the
# three norms fuse into one bucket; of the streamed ones, the five of
# 32 KB and up shard (the mixed fleet lowers the floor to 16 KB: all
# nine shard)
DP_FUSION, DP_SHARD_MIN = "16384", "32768"
DP_V, DP_S, DP_STEPS, DP_LR, DP_MU = 64, 32, 2, 0.05, 0.9


def dp_tokens():
    """Four rows of tokens: rows 0 and 1 are the dp group's (rank r takes
    row r, as device r of the JAX mesh does), rows 2 and 3 the other
    worker's in the mixed fleet."""
    return np.random.RandomState(2).randint(
        0, DP_V, (4, DP_S + 1)).astype(np.int32)


def shard_helper_inputs(rank: int):
    """Odd sizes (padding), a matrix and ints, per rank."""
    rng = np.random.RandomState(400 + rank)
    return {"odd": rng.randn(7).astype(np.float32),
            "mat": rng.randn(5, 3).astype(np.float32),
            "ints": np.array([-7 - rank, 3, 9 + 2 * rank, -1, 4], np.int32)}


def _ps_env_for(port: int, num_workers: int = 1, worker_id: int = 0,
                **extra) -> None:
    import os
    for k in ("BYTEPS_SERVER_HOSTS", "DMLC_ROLE", "BYTEPS_GLOBAL_RANK",
              "BYTEPS_LOCAL_RANK", "BYTEPS_LOCAL_SIZE",
              "BYTEPS_PARTITION_BYTES", "BYTEPS_MIN_COMPRESS_BYTES"):
        os.environ.pop(k, None)
    os.environ.update({
        "DMLC_NUM_WORKER": str(num_workers), "DMLC_NUM_SERVER": "1",
        "DMLC_WORKER_ID": str(worker_id), "DMLC_PS_ROOT_URI": "127.0.0.1",
        "DMLC_PS_ROOT_PORT": str(port), "BYTEPS_FUSION_BYTES": DP_FUSION,
        "BYTEPS_SHARD_MIN_BYTES": DP_SHARD_MIN, **extra})


def _dp_dense_run(rank, world, store, params, cfg, row, shard, steps,
                  sgd_momentum=DP_MU, rowsparse=None):
    """The dense PS steps of a dp group: losses, parameters, declared
    names and the step's counters."""
    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import make_ps_train_step

    bps.init(device="cpu", store=dist.FileStore(store, world), rank=rank,
             world_size=world)
    try:
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(params, device="cpu"))
        opt = torch.optim.SGD(model.parameters(), lr=DP_LR,
                              momentum=sgd_momentum)
        step = make_ps_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg), opt,
            model.params(), local_shard_export=shard,
            rowsparse_params=rowsparse)
        batch = {"tokens": torch.from_numpy(dp_tokens()[row: row + 1])}
        losses = [float(step(batch)) for _ in range(steps)]
        out = {"losses": np.array(losses),
               "names": np.array(sorted(bps.get_state().registry._contexts)),
               "keys": np.array(sorted(
                   f"{n}={c.declared_key}" for n, c in
                   bps.get_state().registry._contexts.items())),
               "bytes_pushed": np.array(step.counters["bytes_pushed"]),
               "shard_leaves": np.array(step.counters["shard_leaves"]),
               "streamed": np.array(step.counters["leaves_streamed"])}
        for n, p in model.named_parameters():
            out["p/" + n.replace(".", "/")] = p.detach().numpy().copy()
        step.close()
    finally:
        bps.shutdown()
    return out


def run_dp_ps(rank: int, world: int, tmp: str, ports, params_path: str,
              out_path: str) -> None:
    """One rank of the dp group's runs: the shard helpers, two dense PS
    steps of tiny() with the shard export off and on (a server each), the
    same with the shard export on and the embedding row-sparse, and two
    device-tier steps under dithering + EF."""
    import dataclasses
    import os

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.ops import push_pull as pp
    from byteps_tpu_torch.training import make_ps_train_step
    import torch.distributed as dist

    params = _load_params(params_path)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=DP_V, seq=DP_S),
                              dtype=torch.float32)
    out = {}
    os.environ.pop("DMLC_NUM_SERVER", None)
    bps.init(device="cpu", store=dist.FileStore(f"{tmp}/store0", world),
             rank=rank, world_size=world)
    try:
        tree = {k: torch.from_numpy(v)
                for k, v in shard_helper_inputs(rank).items()}
        shards = pp.reduce_scatter_tree(tree)
        gathered = pp.all_gather_tree(shards, tree)
        for k in tree:
            out[f"shard/{k}"] = shards[k].numpy()
            out[f"gather/{k}"] = gathered[k].numpy()
    finally:
        bps.shutdown()
    for shard, port in zip((False, True), ports[:2]):
        _ps_env_for(port)
        run = _dp_dense_run(rank, world, f"{tmp}/store{int(shard) + 1}",
                            params, cfg, rank, shard, DP_STEPS)
        out.update({f"{'on' if shard else 'off'}/{k}": v
                    for k, v in run.items()})
    _ps_env_for(ports[3])
    run = _dp_dense_run(rank, world, f"{tmp}/store4", params, cfg, rank,
                        True, DP_STEPS, rowsparse=("embed",))
    out.update({f"rs/{k}": v for k, v in run.items()})
    _ps_env_for(ports[2], BYTEPS_MIN_COMPRESS_BYTES="16384")
    bps.init(device="cpu", store=dist.FileStore(f"{tmp}/store3", world),
             rank=rank, world_size=world)
    try:
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(params, device="cpu"))
        step = make_ps_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg),
            torch.optim.SGD(model.parameters(), lr=DP_LR), model.params(),
            compression={"compressor": "dithering", "ef": "vanilla"})
        batch = {"tokens": torch.from_numpy(dp_tokens()[rank: rank + 1])}
        out["dev/losses"] = np.array([float(step(batch))
                                      for _ in range(DP_STEPS)])
        out["dev/grads"] = np.concatenate(
            [p.grad.reshape(-1).numpy() for p in model.parameters()])
        out["dev/params"] = np.concatenate(
            [p.detach().reshape(-1).numpy() for p in model.parameters()])
        for n, p in model.named_parameters():
            out["dev/p/" + n.replace(".", "/")] = p.detach().numpy().copy()
        plans = {} if step.device_compressor() is None else \
            step.device_compressor()._plans
        out["dev/rounds"] = np.array(len(plans))
        out["dev/compressed"] = np.array(sorted(
            n[len("grad/"):] for n, pl in plans.items() if any(pl.codecs)))
    finally:
        bps.shutdown()
    np.savez(out_path, **out)


def run_dp_mixed(rank: int, world: int, tmp: str, port: int,
                 params_path: str, out_path: str) -> None:
    """The torch half of a mixed fleet: worker 1 of two, a dp group of two
    (rows 2 and 3 of ``dp_tokens``), one dense step with every streamed
    leaf sharded."""
    import dataclasses

    import torch

    from byteps_tpu_torch.models import llama as tl

    params = _load_params(params_path)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=DP_V, seq=DP_S),
                              dtype=torch.float32)
    _ps_env_for(port, num_workers=2, worker_id=1,
                BYTEPS_SHARD_MIN_BYTES=DP_FUSION)
    run = _dp_dense_run(rank, world, f"{tmp}/mixed", params, cfg, 2 + rank,
                        True, 1, sgd_momentum=0.0)
    np.savez(out_path, **run)


def save_params(path: str, params) -> None:
    """A nested dict of arrays as one npz, keys joined by "/"."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


def _load_params(path: str):
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            *parents, last = k.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = z[k]
    return tree


def run_mixed_stream(port: int, params_path: str, out_path: str,
                     stream: str, timeout_s: str) -> None:
    """The torch half of a mixed fleet of two PS workers: worker 1, one
    process, two dense host-tier SGD steps of tiny() on row 1 of
    ``dp_tokens`` with BYTEPS_STREAM_EXPORT=``stream``. A round that
    never completes raises after ``timeout_s`` seconds
    (BYTEPS_CLIENT_TIMEOUT_S), so the process ends either way."""
    import dataclasses

    import torch

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import make_ps_train_step

    _ps_env_for(port, num_workers=2, worker_id=1,
                BYTEPS_STREAM_EXPORT=stream,
                BYTEPS_CLIENT_TIMEOUT_S=timeout_s,
                BYTEPS_NATIVE_CODEC="0")
    params = _load_params(params_path)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=DP_V, seq=DP_S),
                              dtype=torch.float32)
    bps.init(device="cpu")
    try:
        model = tl.Llama(cfg, device="cpu",
                         params=tl.params_from_jax(params, device="cpu"))
        step = make_ps_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg),
            torch.optim.SGD(model.parameters(), lr=DP_LR, momentum=DP_MU),
            model.params())
        batch = {"tokens": torch.from_numpy(dp_tokens()[1:2])}
        out = {"losses": np.array([float(step(batch))
                                   for _ in range(DP_STEPS)]),
               "keys": np.array(sorted(
                   f"{n}={c.declared_key}" for n, c in
                   bps.get_state().registry._contexts.items())),
               "streamed": np.array(step.counters["leaves_streamed"])}
        for n, p in model.named_parameters():
            out["p/" + n.replace(".", "/")] = p.detach().numpy().copy()
        step.close()
    finally:
        bps.shutdown()
    np.savez(out_path, **out)


# the cross-barrier carry over a dp group of two: an MLP, each rank its
# own batch, a server that sleeps and throttles, the keys after the
# backward (tests/test_torch_port_cross_barrier.py)
XB_DP_HIDDEN = (256, 256, 256)
XB_DP_STEPS = 8


def xb_dp_setup(rank: int):
    """(config, initial weights, this rank's batch) of the dp carry run;
    the weights are every rank's."""
    import torch

    from byteps_tpu_torch.models import mlp
    cfg = mlp.MLPConfig(in_dim=64, hidden=XB_DP_HIDDEN, n_classes=10)
    init = {k: v.numpy() for k, v in mlp.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").items()}
    rs = np.random.RandomState(100 + rank)
    batch = {"x": torch.from_numpy(rs.rand(32, 64).astype(np.float32)),
             "y": torch.from_numpy(rs.randint(0, 10, 32).astype(np.int64))}
    return cfg, init, batch


def run_dp_carry(rank: int, world: int, store_path: str, port: int,
                 out_path: str) -> None:
    """One rank of a dp group of two under cross-barrier staleness 1:
    XB_DP_STEPS host-tier Adam steps, then ``flush()``; writes each step's
    carried leaves, the losses and the parameters."""
    import os

    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import mlp
    from byteps_tpu_torch.training import make_ps_train_step

    _ps_env_for(port, BYTEPS_FUSION_BYTES="256", BYTEPS_CROSS_BARRIER="1",
                BYTEPS_STALENESS="1", BYTEPS_STREAM_EXPORT="0")
    os.environ.pop("BYTEPS_SHARD_MIN_BYTES", None)
    cfg, init, batch = xb_dp_setup(rank)
    bps.init(device="cpu", store=dist.FileStore(store_path, world),
             rank=rank, world_size=world)
    out = {}
    try:
        model = mlp.MLP(cfg, "cpu", params=mlp.params_from_jax(init, "cpu"))
        step = make_ps_train_step(
            lambda b: mlp.loss_fn(model.params(), b, cfg),
            torch.optim.Adam(model.parameters(), lr=1e-2),
            model.params())
        losses, carried = [], []
        # the root's replies of the last two weights complete after each
        # step's drain, so that a loaded host cannot empty the schedule
        from _torch_port_ps_util import held_replies
        with held_replies(("grad/w2", "grad/w3") if rank == 0 else ()) \
                as release:
            for _ in range(XB_DP_STEPS):
                losses.append(float(step(batch)))
                carried.append(";".join(step.counters["carried"]))
                release()
        step.flush()
        out["flushed_carry"] = np.array(step._carry is None)
        step.close()
        out["losses"] = np.array(losses)
        out["carried"] = np.array(carried)
        for n, p in model.named_parameters():
            out["p/" + n] = p.detach().numpy().copy()
    finally:
        bps.shutdown()
    np.savez(out_path, **out)


# a mixed fleet's join: the port's worker 1 of two
ELASTIC_MIXED = (("em/a", 5000), ("em/b", 2048), ("em/c", 9000),
                 ("em/d", 300), ("em/e", 4100))


def elastic_mixed_inputs(worker: int):
    rs = np.random.RandomState(40 + worker)
    return [rs.randn(n).astype(np.float32) for _, n in ELASTIC_MIXED]


def elastic_table(registry):
    """The routing table as strings: name, key, then each partition's key,
    offset, length and server."""
    return [f"{c.name}={c.declared_key}:" + ",".join(
        f"{p.key}/{p.offset}/{p.length}/{p.server}" for p in c.partitions)
        for c in registry.contexts_in_order()]


def run_elastic_mixed(ports, out_path: str) -> None:
    """Worker 1 of a JAX + port fleet: a round of every tensor on server
    0, a join of server 1 at the round boundary, a second round; writes
    both rounds' aggregates and the routing table after the join."""
    import os

    import byteps_tpu_torch as bps
    addrs = [f"127.0.0.1:{p}" for p in ports]
    _ps_env_for(ports[0], num_workers=2, worker_id=1,
                BYTEPS_PARTITION_BYTES="8192", BYTEPS_SERVER_HOSTS=addrs[0])
    os.environ.pop("BYTEPS_RETIRED_SERVERS", None)
    bps.init(device="cpu")
    out = {}
    try:
        xs = elastic_mixed_inputs(1)
        for r in range(2):
            if r == 1:
                out["join"] = np.array(bps.add_server(addrs[1]))
                out["table"] = np.array(elastic_table(
                    bps.get_state().registry))
            for (name, _), x in zip(ELASTIC_MIXED, xs):
                out[f"{r}/{name}"] = bps.synchronize(
                    bps.push_pull_async(x, name))
    finally:
        bps.shutdown()
    np.savez(out_path, **out)


# ``make_zero_train_step`` on a dp group of two: Llama tiny() in f32
ZERO_V, ZERO_S, ZERO_LR = 64, 32, 0.05
ZERO_ADAM_STEPS, ZERO_SGD_STEPS = 3, 2
ODD_SHAPES = {"odd": (7, 3), "vec": (5,)}


def zero_tokens():
    """Row r is rank r's batch (device r's of the JAX mesh)."""
    return np.random.RandomState(5).randint(
        0, ZERO_V, (2, ZERO_S + 1)).astype(np.int32)


def odd_tree_inputs():
    """A tree with leaves of odd sizes (padded shards) and, per rank, the
    weights of a quadratic loss over it."""
    rng = np.random.RandomState(7)
    params = {k: rng.randn(*s).astype(np.float32)
              for k, s in ODD_SHAPES.items()}
    weights = [{k: rng.randn(*s).astype(np.float32)
                for k, s in ODD_SHAPES.items()} for _ in range(2)]
    return params, weights


def _replay_adam(tensors, loss_of, steps, group):
    """Adam over the whole leaves on the group's mean gradient."""
    import torch
    import torch.distributed as dist

    opt = torch.optim.Adam(tensors, lr=1e-3)
    for _ in range(steps):
        loss = loss_of()
        grads = torch.autograd.grad(loss, tensors)
        for t, g in zip(tensors, grads):
            dist.all_reduce(g, group=group)
            t.grad = g / dist.get_world_size(group)
        opt.step()


def run_zero(rank: int, world: int, store_path: str, params_path: str,
             out_path: str) -> None:
    """One rank of the ZeRO-1 runs: Adam on Llama tiny() and on a tree of
    odd-sized leaves, each beside a replay of Adam on the mean gradient
    over the whole leaves; SGD + momentum on tiny() for the comparison
    with JAX. Saves parameters, losses, shard and state sizes."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import llama as tl
    from byteps_tpu_torch.training import (init_zero_state,
                                           make_zero_train_step)

    init = _load_params(params_path)
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=ZERO_V,
                                                  seq=ZERO_S),
                              dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(zero_tokens()[rank: rank + 1])}
    bps.init(device="cpu", store=dist.FileStore(store_path, world),
             rank=rank, world_size=world)
    out = {}
    try:
        group = bps.get_state().group

        def llama():
            return tl.Llama(cfg, device="cpu",
                            params=tl.params_from_jax(init, device="cpu"))

        # Adam on Llama: ZeRO against the replay
        model = llama()
        params_before = [p for p in model.parameters()]
        zs = init_zero_state(model.params(),
                             lambda s: torch.optim.Adam(s, lr=1e-3))
        step = make_zero_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg), model.params(), zs)
        out["adam/losses"] = np.array([float(step(batch))
                                       for _ in range(ZERO_ADAM_STEPS)])
        out["adam/same_objects"] = np.array(all(
            a is b for a, b in zip(params_before, model.parameters())))
        replay = llama()
        _replay_adam(list(replay.parameters()),
                     lambda: tl.loss_fn(replay.params(), batch, cfg),
                     ZERO_ADAM_STEPS, group)
        for (n, p), q in zip(model.named_parameters(), replay.parameters()):
            key = n.replace(".", "/")
            out["adam/p/" + key] = p.detach().numpy().copy()
            out["adam/replay/" + key] = q.detach().numpy().copy()
        out["adam/names"] = np.array(zs.names)
        out["adam/shard_len"] = np.array([s.numel() for s in zs.shards])
        out["adam/state_len"] = np.array([
            [zs.optimizer.state[s]["exp_avg"].numel(),
             zs.optimizer.state[s]["exp_avg_sq"].numel()]
            for s in zs.shards])
        out["adam/state_bytes"] = np.array(zs.state_bytes())

        # Adam on a tree of odd-sized leaves
        p0, weights = odd_tree_inputs()
        w = {k: torch.from_numpy(v) for k, v in weights[rank].items()}

        def odd_loss(tree):
            return sum(torch.sum(w[k] * tree[k] * tree[k]) for k in tree)

        tree = {k: torch.from_numpy(v.copy()).requires_grad_()
                for k, v in p0.items()}
        zs = init_zero_state(tree, lambda s: torch.optim.Adam(s, lr=1e-3))
        step = make_zero_train_step(lambda b: odd_loss(tree), tree, zs)
        for _ in range(ZERO_ADAM_STEPS):
            step(None)
        ref = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in p0.items()}
        _replay_adam([ref[k] for k in sorted(ref)], lambda: odd_loss(ref),
                     ZERO_ADAM_STEPS, group)
        for k in tree:
            out["odd/p/" + k] = tree[k].detach().numpy().copy()
            out["odd/replay/" + k] = ref[k].detach().numpy().copy()
        for n, s in zip(zs.names, zs.shards):
            out["odd/shard/" + n] = s.detach().numpy().copy()

        # SGD + momentum on Llama, for JAX
        model = llama()
        zs = init_zero_state(model.params(), lambda s: torch.optim.SGD(
            s, lr=ZERO_LR, momentum=0.9))
        step = make_zero_train_step(
            lambda b: tl.loss_fn(model.params(), b, cfg), model.params(), zs)
        out["sgd/losses"] = np.array([float(step(batch))
                                      for _ in range(ZERO_SGD_STEPS)])
        for n, p in model.named_parameters():
            out["sgd/p/" + n.replace(".", "/")] = p.detach().numpy().copy()
    finally:
        bps.shutdown()
    np.savez(out_path, **out)
