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


def run_rank(rank: int, world: int, store_path: str, out_path: str) -> None:
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
        kw = {"compressor": "onebit", "ef": "vanilla"}
        stacks = default_stacks([a, b], kw, min_compress_bytes=1024)
        states = [s.init_state(g.numel()) if s else {}
                  for g, s in zip((a, b), stacks)]
        out, new_states = compressed_psum_tree(
            [a, b], states, stacks, bps.get_state().group)
        summed = psum_tree({"ints": ints}, average=True)
        mean = bps.push_pull(torch.tensor([float(rank)]))
        params = [torch.full((3,), float(rank))]
        broadcast_parameters(params, root_rank=1)
        np.savez(out_path, a=out[0].numpy(), b=out[1].numpy(),
                 error=new_states[0]["error"].numpy(),
                 ints=summed["ints"].numpy(), mean=mean.numpy(),
                 bcast=params[0].numpy())
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
